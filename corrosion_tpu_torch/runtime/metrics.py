"""Lane names of the SWIM kernel's device telemetry.

The port's own copy of the three tuples that fix the layout of
`SwimState.events` and `SwimState.ring` (the JAX package keeps them in
`corrosion_tpu/runtime/metrics.py`). The order is a wire format: every
drained event vector and flight-ring row is indexed in it, so it must
stay identical to the reference's (tests/test_torch_swim.py pins it).
"""

# Cumulative event lane, one int32 counter per protocol event (wraps
# mod 2^32; drains take uint32 deltas).
KERNEL_EVENTS = (
    "gossip_emitted",  # gossip messages sent (sender+receiver up, same
    #                    partition; includes anti-entropy lanes)
    "gossip_lost",  # of those, dropped by iid loss injection
    "inbox_delivered",  # messages that landed in a bounded inbox
    "inbox_overflowed",  # messages dropped at the inbox cap
    "merge_won",  # inbox/own-update entries that improved the view
    "feed_pulls",  # successful feed-window partner exchanges
    "seed_pulls",  # bootstrap-seed window exchanges
    "suspect_raised",  # failed indirect probes -> new suspicions
    "down_declared",  # suspicion timers fired un-refuted
    "refuted",  # members that refuted by bumping incarnation
    "self_announced",  # periodic self-announces entering gossip
    "suspicion_confirmations",  # Lifeguard: confirming suspect messages
    #                             applied to open suspicion timers
    "suspect_fp",  # of suspect_raised, subjects that are in fact alive
    "down_fp",  # of down_declared, subjects that are in fact alive
)

# Flight-ring census lanes: point-in-time [N]-shaped integer reductions
# recorded after each tick's event deltas.
FLIGHT_CENSUS = (
    "census_alive",  # ground-truth live processes
    "census_suspect",  # open suspicion timers cluster-wide
    "census_down",  # ground-truth dead processes
    "inbox_highwater",  # max per-member valid inbox entries this tick
    "inc_max",  # max incarnation
    "lhm_max",  # max Local Health Multiplier score (Lifeguard)
)

# One ring row = event deltas then census, in this order.
FLIGHT_LANES = KERNEL_EVENTS + FLIGHT_CENSUS
