"""The plain reference the correctness check compares the program with.

Plain NumPy and PyTorch.  It imports nothing of the program: what the
program derives from the benchmark's inputs (index sizes and the size
model's fit, RMI models, page-reference profiles, hit rates, the chosen
configuration) it works out again here, profiles and hit rates in float64.
Index construction and the size-model fit are frozen copies of the
program's (their output is a definition, not an approximation to check).
"""
