"""The plain reference: `hk`, a frozen copy of hikari_tpu_torch's plain
PyTorch versions (every kernel's plain version, the frame, the carry, the
refit and the post-overlay, run eagerly), and `compare`, the comparison
that decides `correct`. Nothing here imports hikari_tpu_torch."""
