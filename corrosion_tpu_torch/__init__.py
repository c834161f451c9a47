"""corrosion-tpu on PyTorch and CUDA: the batched SWIM membership simulator.

The counterpart of `corrosion_tpu`'s device half, written for an NVIDIA
Hopper card. Module names mirror the JAX package's so each counterpart is
easy to find:

- `random`: a bit-exact threefry2x32 counterpart of the `jax.random`
  calls the tick makes (keys live on the host, bits on the device);
- `ops.swim`: the dense SWIM tick, its k-tick loop and its stats;
- `ops.inbox_cuda`: the gossip-inbox build, a hand-written CUDA kernel
  (`csrc/inbox.cu`) beside its plain PyTorch version;
- `models.cluster`: `ClusterSim`, the simulated devcluster driver;
- `bench`: time to stable membership, one JSON line.

Entry points run on the card by default (`runtime.device.resolve_device`);
the CPU is used only when a caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
