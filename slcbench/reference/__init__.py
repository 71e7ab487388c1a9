"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch versions (Gray + phase decode, heterodyne decode, triangulation,
stripe tracking, the phase lock), with every floating-point operation in
one ``dtype`` so that the control can run it a precision lower.

It imports nothing of the program. The harness hands it the same
calibration and images it hands the program, and it works out every
table and tracker state itself.
"""
