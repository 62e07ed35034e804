"""The plain reference against exact arithmetic and against the port's
plain path (the block kernel's plain version on the CPU), at small
sizes."""
from __future__ import annotations

import fractions
import json
import pathlib

import numpy as np
import pytest
import torch

from cepbench import check as CK, traffic
from cepbench.reference import engine as E, model as RM, patterns as RP
from cepbench.reference.arith import F32, Arith, fma32, to_bf16

ROOT = pathlib.Path(__file__).resolve().parent.parent
DENSE = {"stock-q1": {"kind": "stock", "num_symbols": 500,
                      "pattern_symbols": 10, "hot_fraction": 0.95,
                      "p_class": 0.1},
         "soccer-q3": {"kind": "soccer", "num_players": 14,
                       "num_strikers": 2, "p_striker": 0.08,
                       "p_defend": 0.88}}


def _config(name):
    return json.loads((ROOT / f"cepbench/configs/{name}.json").read_text())


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(2000).astype(F32) *
               F32(2.0) ** rng.integers(-20, 20, 2000).astype(F32)
               for _ in range(3))
    got = fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = fractions.Fraction(float(x)) * fractions.Fraction(float(y)) \
            + fractions.Fraction(float(z))
        lo = np.nextafter(g, -np.inf)
        hi = np.nextafter(g, np.inf)
        err = abs(fractions.Fraction(float(g)) - exact)
        assert err <= abs(fractions.Fraction(float(lo)) - exact)
        assert err <= abs(fractions.Fraction(float(hi)) - exact)
    assert fma32(a[:1], b[:1], c[:1])[0] == fma32(a[0], b[0], c[0])


def test_bfloat16_rounding_matches_torch():
    x = np.random.default_rng(1).standard_normal(5000).astype(F32) * F32(300)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(to_bf16(x), want)
    assert to_bf16(F32(1.0)).shape == ()


def test_quantiles_match_the_telemetry():
    from repro_torch.runtime import telemetry
    rng = np.random.default_rng(2)
    for n in (1, 7, 1024, 131072):
        x = rng.random(n).astype(F32)
        want = telemetry.quantiles(torch.from_numpy(x)).numpy()
        assert np.array_equal(CK.quantiles(x, Arith()), want)


def _program(cfg, L):
    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng, patterns as pat, runner
    specs = [getattr(pat, "make_" + p["query"].lower())(
        **{k: v for k, v in p.items() if k != "query"})
        for p in cfg["patterns"]]
    cp = pat.compile_patterns(specs)
    pcfg = runner.default_config(
        cp, max_pms=cfg["max_pms"], latency_bound=cfg["latency_bound"],
        shedder="pspice", backend="cuda_block",
        block_events=cfg["block_events"], **cfg["cost"])
    return RT, eng, runner, specs, cp, pcfg


def _batch(eng, d):
    return eng.EventBatch(*(torch.from_numpy(np.ascontiguousarray(d[k]))
                            for k in traffic.FIELDS))


@pytest.mark.parametrize("name", ["stock-q1", "soccer-q3"])
def test_reference_equals_the_port(name):
    """Model build from a warm-up, then 2 lanes of 448 events through the
    port's MultiTenantRuntime (pushes of 64): every carry leaf of each
    lane equals the reference's, bit for bit."""
    # 448 events of the configuration's sparse streams open a PM or two
    # and do not queue up to its 1 s bound: denser streams and a bound
    # of 50 ms make the shedder fire within them.
    cfg = dict(_config(name), latency_bound=0.05,
               generator=DENSE[name])
    L, n = 2, 448
    RT, eng, runner, specs, cp, pcfg = _program(cfg, L)
    warm = traffic.warm_stream(cfg, 600)
    built = runner.build_model(specs, pcfg, _batch(eng, warm),
                               bin_size=cfg["bin_size"], seed=0,
                               device="cpu")
    pats = RP.compile_specs(cfg["patterns"])
    prm = CK.params(cfg, pats)
    ref = RM.build(prm, pats, warm, cfg["bin_size"])
    for x, y in zip(built.T + built.R, ref.T + ref.R):
        assert np.array_equal(x.numpy(), y)
    assert (float(built.f_model.a), float(built.f_model.b)) == \
        (float(ref.f[0]), float(ref.f[1]))
    assert built.max_rate == ref.max_rate
    assert np.allclose(built.ut_stacked.numpy(), ref.tables, rtol=1e-5,
                       atol=1e-6 * np.abs(ref.tables).max())
    ev = traffic.session_sets(cfg, dict(lanes=L, session_events=n,
                                        session_sets=1), 3)[0]
    ev["arrival"] = np.stack([traffic.arrivals(n, r) for r in
                              traffic.lane_rates(dict(
                                  lanes=L, rate_lo=1.3, rate_hi=1.6),
                                  built.max_rate)])
    model = eng.make_model(cp, pcfg, ut_tables=built.ut_stacked,
                           ut_bins=built.ut_bins, f_model=built.f_model,
                           g_model=built.g_model, device="cpu")
    rt = RT.MultiTenantRuntime(pcfg, RT.broadcast_model(model, L), L,
                               rt=RT.RuntimeConfig(chunk_size=64),
                               device="cpu")
    evb = _batch(eng, ev)
    for a in range(0, n, 64):
        rt.push(eng.EventBatch(*(x[:, a:a + 64] for x in evb)))
    st = E.State.fresh(L, *pats["trans"].shape[:2], prm)
    m = CK.ref_model(dict(ut_tables=built.ut_stacked.numpy(),
                          ut_bins=built.ut_bins.numpy(),
                          f=(float(built.f_model.a), float(built.f_model.b),
                             int(built.f_model.kind)),
                          g=(float(built.g_model.a), float(built.g_model.b),
                             int(built.g_model.kind))))
    out = E.run(prm, pats, m, st, ev, 0)
    carry = {k: v.numpy() for k, v in rt.carry.pms._asdict().items()}
    carry.update({k: v.numpy() for k, v in rt.carry._asdict().items()
                  if k != "pms"})
    assert CK.leaves_differing(carry, st, np.arange(L)) == []
    assert out.shed.any() and float(st.pms_created.sum()) > 0


def test_fma_rounds_midpoints_correctly():
    """A sum whose float64 rounding lands on a float32 midpoint: (1 +
    2**-23)·(1 - 2**-23)·2**-24 + (1 + 2**-23) is 2**-70 below the
    midpoint 1 + 3·2**-24, which float64 cannot hold; float32 rounds the
    midpoint to even (1 + 2**-22), the exact value to 1 + 2**-23."""
    a = F32(1 + 2.0 ** -23)
    b = F32((1 - 2.0 ** -23) * 2.0 ** -24)
    c = F32(1 + 2.0 ** -23)
    assert float(a) * float(b) + float(c) == 1 + 3 * 2.0 ** -24
    got = fma32(np.array([a, -a], F32), np.array([b, b], F32),
                np.array([c, -c], F32))
    assert got.tolist() == [float(c), -float(c)]
    assert fma32(a, b, c) == c
