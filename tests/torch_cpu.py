"""CPU settings shared by the port's parity tests (``test_torch_*.py``).

The suite runs in several worker processes on a machine with a few
cores, and torch starts one intra-op thread per core in every worker: the
workers' threads then outnumber the cores many times over and spin
against each other, while the port's tests multiply tensors of a few
hundred elements a side, too small for threads to help.  One intra-op
thread per worker keeps the results of every test and gives back the
cores (the port's files took about a quarter of the worker time with one
thread as with eight, in a run of the suite's command with 6 workers on 8
cores).  Each port test module imports this one, so the setting holds
whichever of them a worker collects first.
"""
import torch

torch.set_num_threads(1)
