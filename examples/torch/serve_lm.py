"""Serve a small LM through the port's continuous-batching engine.

Trains a reduced qwen3 on the synthetic bigram stream first (so generation
is non-trivial: the model learns the transition table), then serves a batch
of prompts — requests flow through a persistent slot cache, admitted and
retired independently (docs/torch/SERVING.md) — and reports whether
generated continuations follow the table.

Run:  PYTHONPATH=src python examples/torch/serve_lm.py \
          [--train-steps 400] [--device cpu]

The port's twin of ``examples/serve_lm.py``: the driver
(``repro_torch.launch.train.train``) and ``ServingEngine`` on the CUDA
device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.launch.train import train
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.data import DataConfig, SyntheticLM


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' trains and serves "
                         "on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("qwen3-0.6b")).replace(vocab_size=64)
    params, history = train(cfg, steps=args.train_steps, global_batch=16,
                            seq_len=64, ckpt_dir=None, data_vocab=64,
                            lr=3e-3, device=device)
    print(f"trained: loss {history[0]:.3f} -> {history[-1]:.3f}")

    # same seed as train() so we score against the SAME transition table
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=1,
                                  seed=0))
    engine = ServingEngine(params, cfg, slots=4, max_seq=64, device=device)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        prompt = [int(t) for t in rng.integers(0, 64, size=3)]
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=8))
    done = engine.run_to_completion()

    hits = total = 0
    for r in done:
        seq = r.prompt + r.output
        for a, b in zip(seq[len(r.prompt) - 1:-1], seq[len(r.prompt):]):
            total += 1
            hits += int(b in data.table[a])
        print(f"req {r.uid}: prompt={r.prompt} -> {r.output}")
    print(f"bigram-consistency of generations: {hits}/{total} "
          f"(chance ~ {4 / 64:.2%})")


if __name__ == "__main__":
    main()
