"""Plain PyTorch references of the model families, one module a family
(``perfbench/reference/<family>.py``).  They import nothing of the program
under test."""
