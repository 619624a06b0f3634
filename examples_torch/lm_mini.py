"""Mini LM end to end on an assigned architecture through the port's
Engine API, on the card (``--device cpu`` runs it on the host): train a
reduced internlm2 / rwkv6 on the synthetic bigram stream until the loss
beats the uniform-entropy floor, then generate greedily by a parallel
prefill and cached decode steps. On the card every attention layer's
forward runs the hand-written flash-attention kernel and every decode
step the flash-decode kernel (rwkv6 has no attention: its mixers are
plain torch, as the reference's are jnp).

Run: PYTHONPATH=src python examples_torch/lm_mini.py [--arch rwkv6-3b]
     [--steps 60] [--device cpu]
"""
import argparse
import math
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data import make_lm_batch
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    print(f"== {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} on {dev}")

    # Engine assembles the training pipeline (step + opt + TrainLoop);
    # LM configs take plan="none" (placement planning is DLRM-only).
    engine = Engine(cfg, lr=3e-3, device=dev)
    session = engine.train_session(batch=8, seq=65, chain_prob=0.9,
                                   schedule_steps=args.steps)

    floor = math.log(cfg.vocab_size)
    t0 = time.time()
    report = session.run(args.steps)
    for s, h in enumerate(report.history):
        if s % 10 == 0 or s == args.steps - 1:
            print(f"  step {s:3d}  ce={float(h['loss']):.3f} "
                  f"(uniform floor {floor:.3f})")
    print(f"== trained {report.steps_run} steps in {time.time()-t0:.1f}s; "
          f"beat floor: {report.last_loss < floor}")

    # generation: parallel prefill + cached decode on the session's params
    params = session.params
    prompt = make_lm_batch(cfg, 12345, batch=1, seq=17,
                           device=dev)["tokens"][:, :8]
    prefill = lm.make_prefill_step(cfg, max_len=32)
    decode = lm.make_decode_step(cfg)
    with torch.no_grad():
        caches, tok = prefill(params, {"tokens": prompt})
        out = [int(tok[0])]
        for i in range(8):
            caches, tok = decode(params, caches, tok,
                                 torch.tensor(8 + i, device=dev))
            out.append(int(tok[0]))
    print(f"== prompt {prompt[0].tolist()} -> generated {out}")


if __name__ == "__main__":
    main()
