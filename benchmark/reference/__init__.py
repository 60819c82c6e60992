"""The benchmark's plain reference: Stable Diffusion's UNet and ControlNet,
DDIM and rectified flow's Euler step, and the TokenFlow edit step in plain
PyTorch, written from the published architecture and TokenFlow's edit (a
frozen, kernel-free copy of the measured program's maths). It imports nothing of the program and takes
none of its weights, tables or state: the harness hands it the same state
dict and inputs it hands the program.

Every product runs in fp32 with TF32 off (``Precision("fp32")``), or, as
the control, with its operands rounded to fp8 e4m3 (``Precision("fp8")``).
"""
