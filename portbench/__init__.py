"""The benchmark of hikari_tpu_torch: replayed 1080p frames under an
orbiting camera, timed as a window with two frames in flight
(`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`). It imports nothing of hikari_tpu or JAX, and its
reference (portbench/reference) imports nothing of hikari_tpu_torch."""
