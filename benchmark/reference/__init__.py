"""The benchmark's plain reference: PyTorch and NumPy only, float32 with
TF32 off. It imports nothing of the program under test and takes nothing
the program made: the harness hands it the inputs it made from the seed."""
