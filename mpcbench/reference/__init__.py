"""The plain reference: a frozen copy of the port's plain path (problem
assembly, the plain ADMM, the IK build, the plain GN-DDP, the 1 kHz
interpolation, the robots and their assets, the gait tables, the physics,
the controller and the closed loop's substep), in plain PyTorch. It imports
nothing of the program and takes nothing the program made: the benchmark
hands it the same inputs it hands the program, and it works out everything
else again. Its module layout is the port's, so ``mpcbench.system`` builds
either side from one configuration file."""
