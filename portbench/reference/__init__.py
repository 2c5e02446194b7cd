"""The benchmark's plain reference: a frozen copy of the renderer's plain
PyTorch megakernel and of the scene generators its cells use. Imports
nothing of the program."""
