"""The least time the card could take for a kernel's work, by kernel: the
larger of its bytes over the peak bandwidth and its operations over the
peak f32 rate (peaks.py), each input read once and each output written
once."""
