"""DSP building blocks of the hop pipeline (PyTorch)."""
