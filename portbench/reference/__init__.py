"""Plain PyTorch references the benchmark judges the program against.

Nothing here imports the program: each module follows the published
equations of its model from the inputs and weights the benchmark made.
"""
