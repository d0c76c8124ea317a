"""The benchmark's plain reference: AGBNP1 + OPLS and the Langevin step
in plain PyTorch (float64; a lower dtype is the control).  It imports
nothing of the program under test."""
