"""Plain float32 reference of the benchmark's models, encoding and chop.

Written from the configurations' published equations in plain PyTorch and
NumPy. It imports nothing of the program (neither package of this
repository) and takes nothing the program made: it gets the harness's
weights and raw reads, works out the implicit filters, the padded inputs,
the labels and the chop itself, and reads the program's outputs only to
judge them.
"""
