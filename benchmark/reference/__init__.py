"""The plain reference the benchmark holds the port to: plain PyTorch that
imports nothing of the port (``ocean`` is a frozen, serial copy of its plain
path)."""
