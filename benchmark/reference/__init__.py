"""The plain reference of the benchmark: the cube-padded model's math in
float32, in plain PyTorch and NumPy, with TF32 off.

A frozen copy of the published model (Cheng et al., CVPR 2018, "Cube
Padding for Weakly-Supervised Saliency Prediction in 360° Videos"): the
equirectangular-to-cube sampling, ImageNet normalization, the cube-padded
ResNet with its stem pool, the class activation map, the window
normalization, the cube-padded ConvLSTM, the projection back to
equirectangular, the three weak-supervision losses and Adam.  It imports
nothing of the program under test: the benchmark hands both sides the same
raw inputs and weights, and the reference works out everything else again.
"""
