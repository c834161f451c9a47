"""corro-analyze for the PyTorch port: AST-based static analysis over
the `corrosion_tpu_torch/` tree.

The same bug classes the JAX package's analyzer guards, held on the
port's own copies of those modules: blocking SQL in `async def`, state
raced between a worker thread and the event loop, network awaits with
no deadline, one-way codec gates, capture/finalize drift, unsafe
actuators, a locking profiler sampler, lane drift between the two SWIM
states, and host syncs inside device code.  A small `Checker` framework
(`core.py`), one checker module per rule, a committed
`ANALYSIS_BASELINE_TORCH.json` for grandfathered findings, and
per-finding `# corro: noqa[rule]` suppressions.  `python -m
corrosion_tpu_torch.corro_lint` is the one command;
`tests/test_torch_analysis.py` is the tier-1 gate.

Rules and the port's scopes (COMPONENTS.md "Static analysis" has the
rules' table):
    kernel-purity   host syncs / host materialization / Python control
                    flow on tensors inside device code of ops/*: every
                    function called in a `with torch.cuda.graph(...)`
                    body and every function a module names in
                    `DEVICE_ROOTS`, with their same-module closure
    lane-parity     SwimState (ops/swim.py) <-> PViewState
                    (ops/swim_pview.py) <-> runtime/metrics.py lanes;
                    the mesh leg waits for parallel/mesh.py
    async-blocking  blocking SQL / sleeps / file I/O directly in
                    `async def` bodies under agent/, api/, pubsub/
    lock-discipline state mutated from both worker-thread and event-loop
                    contexts without a lock (the whole package)
    codec-ext       every version-gated ext of types/codec.py and
                    net/gossip_codec.py has a read path, a write path
                    and a compat test among tests/test_torch_*.py
    metrics-doc     series emitted under corrosion_tpu_torch/ <->
                    COMPONENTS.md observability table (both directions)
    capture-parity  store/crdt.py trigger DDL <-> store/capture.py
    finalize-parity store/crdt.py glue <-> native/crdt_batch.cpp (the
                    native source the port builds, `native.py`)
    timeout-discipline  network awaits in agent/ and api/ carry
                    wait_for deadlines
    actuator-discipline  remediation actuators declare cooldown and
                    record CENSUS + FLIGHT (the whole package)
    profiler-safety code reachable from runtime/profiler.py's
                    `sample_once` takes no lock but _fold_lock, calls no
                    asyncio and allocates nothing per sample
"""

from corrosion_tpu_torch.analysis.core import (  # noqa: F401
    AnalysisContext,
    Checker,
    Finding,
    all_checkers,
    load_baseline,
    run_analysis,
    save_baseline,
)
