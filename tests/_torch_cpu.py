"""The port's CPU tests run their torch ops on one intra-op thread.

Their models are tiny (widths of 64), so an op split over every core
spends its time waiting on the slowest of its OpenMP threads, and the
suite's parallel workers (pytest-xdist, several processes a core count)
oversubscribe the cores with those threads until each waits on the
others. The port's shared test helpers import this module, so it holds in
every process that collects them."""

import torch

torch.set_num_threads(1)
