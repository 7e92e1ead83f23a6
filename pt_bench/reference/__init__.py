"""The plain reference path tracer that decides ``correct``: plain PyTorch, nothing of the port."""
