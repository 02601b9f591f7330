"""The benchmark's plain reference: the path tracer's mathematics in plain
PyTorch, frozen here so that no change to the program moves the yardstick.

It imports nothing of the program.  Every function takes its float dtype
from its inputs, so the same code computes the float32 reference and the
lower-precision control (bfloat16) that a sound limit has to reject.
"""
