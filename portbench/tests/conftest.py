"""Few threads a test process: the tests run in several workers."""

import torch

torch.set_num_threads(2)
