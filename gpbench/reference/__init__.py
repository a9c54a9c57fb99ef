"""The plain reference that decides ``correct``: exact Gaussian-process
arithmetic in plain PyTorch on sorted 1-D inputs, written from george's
kernel conventions. It imports nothing of the measured program."""
