"""Optical flow: the host OpenCV path and the device solvers (Horn-Schunck,
and the DeepFlow/Brox energy), in plain PyTorch."""
