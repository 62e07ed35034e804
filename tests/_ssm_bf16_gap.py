"""How far decode drifts from the full forward in the SSM models, in the
reference and in the port, on the CPU.

Prefill a prompt, decode one token, and compare its logits with the full
forward over the prompt and that token, as max|Δ| / max|logits|
(``tests/test_models.py:71``'s reading), for mamba2 and zamba2 cut in
width (and in depth where asked), in float32 and in bf16.  In bf16 the
chunked SSD of prefill and the recurrent step of decode round apart, and
the gap grows with depth: this script gives the reference's own reading
beside the port's, which ``chip_smoke.py``'s ssm phase logs, and does not
gate, at full width on the card.

    cd tests && JAX_PLATFORMS=cpu PYTHONPATH=../src python _ssm_bf16_gap.py

Prints one line per (config, depth, dtype, package); takes a few minutes.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as RR
from repro.models import decode as RD
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.models import convert
from repro_torch.models import decode as TD
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

B, S = 2, 256
# (arch, width overrides, depths): mamba2 at d 512 (state 64), zamba2 at
# d 448 (4 heads of its 112), both at chunk 64 and a 1 024-token vocab.
CUTS = (("mamba2-1.3b", dict(d_model=512, ssm_state=64), (12, 48)),
        ("zamba2-7b", dict(d_model=448, num_heads=4, num_kv_heads=4,
                           d_ff=1792), (12, 81)))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def reference_gap(cfg, params, toks) -> float:
    cache, _ = RD.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :S])},
                          max_len=S + 4, remat=False)
    got, _ = RD.decode_step(cfg, params, cache, jnp.asarray(toks[:, S]))
    h, _ = RT.backbone(cfg, params, RT.embed_inputs(
        cfg, params, {"tokens": jnp.asarray(toks)}), remat=False)
    h = RL.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    want = RT.lm_head_logits(cfg, params, h[:, -1:])[:, 0]
    return _rel(_f32(got), _f32(want))


def port_gap(cfg, params, toks) -> float:
    cache, _ = TD.prefill(cfg, params, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len=S + 4)
    got, _ = TD.decode_step(cfg, params, cache, torch.from_numpy(toks[:, S]))
    h, _ = TT.backbone(cfg, params, TT.embed_inputs(
        cfg, params, {"tokens": torch.from_numpy(toks)}))
    h = TL.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    want = TT.lm_head_logits(cfg, params, h[:, -1:])[:, 0]
    return _rel(got.float().numpy(), want.float().numpy())


def main() -> int:
    toks = np.random.default_rng(1).integers(0, 1024, (B, S + 1)).astype(
        np.int32)
    for arch, width, depths in CUTS:
        for depth in depths:
            for dtype in ("float32", "bfloat16"):
                if dtype == "float32" and depth != depths[0]:
                    continue
                cfg = dataclasses.replace(
                    RR.get_config(arch), num_layers=depth, ssm_chunk=64,
                    vocab_size=1024, dtype=dtype, **width)
                rparams = RT.init_params(cfg, jax.random.PRNGKey(0))
                ref = reference_gap(cfg, rparams, toks)
                tparams = convert.params_from_numpy(
                    jax.tree.map(_f32, rparams), "cpu",
                    torch.bfloat16 if dtype == "bfloat16" else None)
                port = port_gap(cfg, tparams, toks)
                print(f"{arch} d_model {cfg.d_model} layers {depth} {dtype}: "
                      f"decode vs full, reference {ref:.3e}, port "
                      f"{port:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
