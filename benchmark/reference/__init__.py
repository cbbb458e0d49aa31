"""The plain reference: the published generator and critic and the WGAN-GP
step, in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands it the same weights, windows and random
generators' seeds that it hands the program.
"""
