"""How sensitive full-width smollm-135m is to float32 rounding, per init.

    python3 tools/torch_init_sensitivity.py

Builds the port's full-width smollm-135m in float32 on the card twice:
with the JAX package's init scales (``transformer_defs`` as written:
1/sqrt(fan_in) on every matrix) and with the card init of
``weights.init_params`` (GPT-2's scales).  For one 600-token prompt it
prints, per init, the largest prompt-logit difference between the HOST
and ACCEL builds and between HOST on the weights and HOST on weights
whose embedding table is scaled by (1 + 1e-6), plus whether the argmax
agrees.  A model in which a 1e-6 perturbation moves the logits by O(1)
cannot give equal tokens on any two float32 implementations.  Needs a
CUDA card.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_init_sensitivity: needs a CUDA card", file=sys.stderr)
        return 1
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params as init_from_defs
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import Geometry, transformer_defs
    from repro_torch.weights import init_params

    cfg = dataclasses.replace(get_arch("smollm-135m"), dtype="float32")
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    inits = {
        "jax_scales": init_from_defs(transformer_defs(cfg, Geometry.of(cfg)),
                                     torch.float32, gen, "cuda"),
        "card_init": init_params(cfg, device="cuda", seed=0),
    }
    n = 600
    toks = np.zeros((1, 1024), np.int32)
    toks[0, :n] = np.random.RandomState(0).randint(0, cfg.vocab_size, n)
    batch = {"tokens": torch.as_tensor(toks, device="cuda"),
             "length": torch.tensor([n], dtype=torch.int32, device="cuda")}
    out = {"device": torch.cuda.get_device_name(0)}
    for name, params in inits.items():
        host, _ = model.prefill_at(params, batch, backend="ref")
        accel, _ = model.prefill_at(params, batch, backend="cuda")
        nudged = dict(params, embed={
            "table": params["embed"]["table"] * (1 + 1e-6)})
        host2, _ = model.prefill_at(nudged, batch, backend="ref")
        out[name] = {
            "host_vs_accel_max_logit_diff": (host - accel).abs().max().item(),
            "host_vs_perturbed_max_logit_diff":
                (host - host2).abs().max().item(),
            "argmax_host_accel_perturbed": [
                int(t.argmax()) for t in (host, accel, host2)],
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
