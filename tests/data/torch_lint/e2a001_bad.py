"""Golden BAD snippet for E2A001: a host buffer handed to torch.from_numpy
(which shares it) and written in place while the copy may be in flight."""
import numpy as np
import torch


class Engine:
    def __init__(self, step):
        self._step = step
        self._next_tok = np.zeros((4, 1), np.int64)
        self._pos = np.zeros(4, np.int64)

    def step(self):
        tok = torch.from_numpy(self._next_tok).to("cuda", non_blocking=True)
        pos = torch.as_tensor(self._pos)
        logits = self._step(tok, pos)
        self._next_tok[0, 0] = 7     # BAD: races the non-blocking copy
        self._pos[0] += 1            # BAD: pos shares this buffer
        return logits
