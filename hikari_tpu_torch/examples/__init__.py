"""The examples of the port: their scenes (minimal, cornell, simple,
scene, city) and command-line entry points (`python -m
hikari_tpu_torch.examples.<name>`), which render on CUDA unless given
`--device cpu`."""
