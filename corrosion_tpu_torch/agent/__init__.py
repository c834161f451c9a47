"""The agent's SWIM layer in the PyTorch port: the standalone
`membership.Membership` prober the kernel-peer bridge is driven with."""
