"""Golden GOOD snippet for E2A001: the buffer is copied (torch.tensor) or
snapshotted (.copy()) before it is written."""
import numpy as np
import torch


class Engine:
    def __init__(self, step):
        self._step = step
        self._next_tok = np.zeros((4, 1), np.int64)
        self._pos = np.zeros(4, np.int64)

    def step(self):
        tok = torch.from_numpy(self._next_tok.copy()).to("cuda",
                                                         non_blocking=True)
        pos = torch.tensor(self._pos)      # copies
        logits = self._step(tok, pos)
        self._next_tok[0, 0] = 7
        self._pos[0] += 1
        return logits
