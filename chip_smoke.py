#!/usr/bin/env python
"""On-card proof that the m-mode product pipeline runs end to end on a GPU.

    python chip_smoke.py               # one card: device, ns2 (+ referee)
    python chip_smoke.py --four-cards  # the ns2 window on a 4-card m-mesh,
                                       # against the same window on one card

One process opens the card(s) once; a second JAX process on the same
card would fail for want of memory.  Every phase prints one JSON line
with its wall time (compile/warm-up apart from the steady pass), the
device's ``peak_bytes_in_use`` and the matmul precision in force.  The
card's nvidia-smi name and power limit come on an earlier line, and the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises, so
the process exits non-zero and prints no ``ok`` line; so does a run that
finds no GPU (there is no CPU fallback).

Phases
------
device   the default backend is a GPU; its kind, count and memory limit.
ns2      the production-shaped polarised cylinder (2 x 9 feeds, npairs
         100, 16 channels over 400-500 MHz, lmax 324, KL pencil n = 3200)
         at full widths over the m-window ``NS2_WINDOW``: resident BTM,
         then the fused product + 10-band Fisher pass.
referee  (part of ns2) two m-modes of the window against a dense
         complex128 generalised eigensolve and the dense
         quadratic-estimator Fisher (tests/_referee.py), on the host.

The file-based product CLI (``drift-makeproducts``) has no phase here:
it writes its products with h5py, which the GPU machines this script is
run on do not have.  The resident path needs no h5py.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Production-shaped polarised cylinder: ntel = 2 * npairs = 200 per
# frequency, (200 x 1300) per-m SVD blocks, KL pencil n = 16 * 200.
NS2 = dict(
    num_freq=16, freq_start=400.0, freq_end=500.0, freq_mode="edge",
    num_cylinders=2, cylinder_width=15.0, num_feeds=9, feed_spacing=1.0,
    tsys=50.0, single_precision=True,
)
# A mid-m window, where the KL retention concentrates.  The number of m
# is cut to fit the run's time; the pencil width never is.
NS2_WINDOW = (90, 106)
NS2_BANDS = 10
KL_CUT = 0.1

# Referee tolerances: the f32 engine's tier against dense complex128 on
# the retained eigenvalues, and BASELINE.md's Fisher tier.
REFEREE_EVAL_RTOL = 2e-3
REFEREE_FISHER_RTOL = 3e-2
# Four cards against one: the same per-m arithmetic, sharded over m.
MESH_RTOL = 1e-5

def require_gpu(devices) -> None:
    """Refuse any backend but a GPU: this script measures nothing else."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else None
        raise RuntimeError(f"chip_smoke needs a GPU; the default backend is {plat!r}")


def ok_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def emit(phase: str, **fields) -> dict:
    """Print one phase line (JSON) with the device's peak memory and the
    matmul precision in force."""
    import jax

    line = {
        "phase": phase,
        **fields,
        "peak_bytes_in_use": _peak_bytes(),
        "matmul_precision": jax.config.jax_default_matmul_precision,
    }
    print(json.dumps(line, default=str), flush=True)
    return line


def phase_device() -> dict:
    import jax

    devices = jax.devices()
    require_gpu(devices)
    stats = devices[0].memory_stats() or {}
    return emit(
        "device",
        platform=devices[0].platform,
        device_kind=devices[0].device_kind,
        count=len(devices),
        bytes_limit=stats.get("bytes_limit"),
    )


def precision_overrides() -> dict:
    """The per-stage matmul-precision overrides (None = library default)."""
    from driftscan_tpu.ops import fpencil, sht
    from driftscan_tpu.parallel import mstep

    return {
        "sht": sht._SHT_PRECISION,
        "topband_filter": fpencil._FILTER_PRECISION,
        "fisher": mstep._FISHER_PRECISION,
    }


# ---------------------------------------------------------------------
# ns2
# ---------------------------------------------------------------------


def _band_cls(tel, nbands):
    """Per-band Stokes-I angular spectra (nl, F, F) over k in [0, 0.4]."""
    import numpy as np

    from driftscan_tpu.core import psestimation, skymodel

    edges = np.linspace(0.0, 0.4, nbands + 1)
    cr = skymodel.Corr21cm()
    cr.ps_2d = False
    out = []
    for ks, ke in zip(edges[:-1], edges[1:]):
        bf = psestimation.bandfunc_2d_polar(ks, ke, 0.0, np.pi / 2)
        crt = skymodel.Corr21cm(
            ps=(lambda k, mu, f=bf: cr.ps_vv(k) * f(k, mu)), redshift=1.5
        )
        crt.ps_2d = True
        out.append(
            skymodel.im21cm_model(
                tel.lmax, tel.frequencies, tel.num_pol_sky, cr=crt, temponly=True
            )
        )
    return out


def ns2_setup(tel_params=NS2, nbands=NS2_BANDS):
    """Telescope, covariance factors and Fisher band tables (host, once)."""
    import numpy as np

    import bench
    from driftscan_tpu.parallel import mstep
    from driftscan_tpu.telescope import cylinder

    tel = cylinder.PolarisedCylinderTelescope.from_config(dict(tel_params))
    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    clb = _band_cls(tel, nbands)
    band_lt = mstep.band_factor_table(iter(clb), out_dtype=np.float32, rank_rtol=1e-9)
    return dict(
        tel=tel, cl_s=cl_s, cl_n=cl_n, noisew=noisew, ls=ls, lf=lf,
        clb=clb, band_lt=band_lt,
    )


def _units(tel):
    import numpy as np

    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


def btm_window(s, window):
    """Resident BTM tables for the window: (pos, neg, warm-up s, steady s)."""
    import jax

    from driftscan_tpu.ops import sht
    from driftscan_tpu.parallel import resident

    blg, fig = _units(s["tel"])
    st = time.time()
    jax.block_until_ready(resident.btm_resident(s["tel"], blg, fig, m_range=window))
    t_warm = time.time() - st
    st = time.time()
    pos, neg = jax.block_until_ready(
        resident.btm_resident(s["tel"], blg, fig, m_range=window)
    )
    t_steady = time.time() - st
    sht.clear_legendre_cache()
    return pos, neg, t_warm, t_steady


def product_window(s, pos, neg, window, cut=KL_CUT, **kw):
    """The fused product + Fisher pass over the window (host results)."""
    from driftscan_tpu.parallel import resident

    return resident.product_all_resident(
        s["tel"], pos, neg, s["ls"], s["lf"], s["noisew"], m_range=window,
        kl_cut=cut, band_lt=s["band_lt"], ps_threshold=cut, **kw,
    )


def check_window(evals, fish, cut=KL_CUT) -> dict:
    """Finite spectra with retained modes; a finite Hermitian Fisher with
    a positive diagonal."""
    import numpy as np

    if not np.isfinite(evals).all():
        raise RuntimeError("non-finite KL eigenvalues")
    retained = int((evals > cut).sum())
    if retained < 1:
        raise RuntimeError(f"no KL mode above the {cut} cut")
    if not np.isfinite(fish).all():
        raise RuntimeError("non-finite Fisher matrix")
    scale = float(np.abs(fish).max())
    herm = float(np.abs(fish - fish.conj().T).max() / scale)
    if herm > 1e-4:
        raise RuntimeError(f"Fisher matrix not Hermitian (rel {herm:.3g})")
    diag = np.real(np.diag(fish))
    if not (diag > 0).all():
        raise RuntimeError(f"Fisher diagonal not positive: {diag}")
    return {
        "retained_modes": retained,
        "max_eval": float(evals.max()),
        "fisher_hermitian_rel": herm,
        "fisher_diag": diag.tolist(),
    }


def referee(s, pos, neg, window, ms, cut=KL_CUT) -> dict:
    """Engine vs dense complex128 on the m-modes ``ms`` of the window."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import _referee
    from driftscan_tpu.parallel import mstep, resident

    tel = s["tel"]
    nl, npol, F = tel.lmax + 1, tel.num_pol_sky, tel.nfreq
    dt = pos.re.dtype

    def step(pr, pi, nr, ni, nw, ls, lf, mv):
        b_re, b_im = resident._build_beam_batch(
            pr, pi, nr, ni, mv, tel.npairs, F, npol, nl, m_lo=np.int32(window[0])
        )
        return mstep.kl_product_step_split(b_re, b_im, nw, ls, lf, mv, npol=npol, nl=nl)

    args = (
        pos.re, pos.im, neg.re, neg.im,
        jnp.asarray(s["noisew"], dt), jnp.asarray(s["ls"], dt),
        jnp.asarray(s["lf"], dt), jnp.asarray(np.asarray(ms, np.int32)),
    )
    st = time.time()
    compiled = jax.jit(step).lower(*args).compile()
    t_compile = time.time() - st
    mem = compiled.memory_analysis()
    st = time.time()
    res = jax.block_until_ready(compiled(*args))
    t_step = time.time() - st

    st = time.time()
    eval_err = []
    for i in range(len(ms)):
        w = _referee.dense_spectrum(
            _referee.beams_of(res, i, npol, nl), s["cl_s"], s["cl_n"]
        )
        k, err = _referee.top_spectrum_error(np.asarray(res.evals[i]), w, cut)
        eval_err.append({"m": int(ms[i]), "k": k, "max_rel": err})

    retained = int((np.asarray(res.evals) > cut).sum(axis=1).max())
    fisher_k = 1 << max(retained - 1, 0).bit_length()
    f_re, f_im = jax.jit(
        functools.partial(
            mstep.fisher_step_split, ps_threshold=cut, fisher_k=fisher_k,
            npol=npol, nl=nl,
        )
    )(res.evals, res.evecs_re, res.evecs_im, res.beam_re, res.beam_im, s["band_lt"])
    got = np.asarray(f_re, np.float64) + 1j * np.asarray(f_im, np.float64)
    want = _referee.dense_fisher(res, s["clb"], cut, npol, nl)
    fisher_err = []
    for i in range(len(ms)):
        scale = float(np.abs(want[i]).max())
        rel = float(np.abs(got[i] - want[i]).max() / scale) if scale else 0.0
        fisher_err.append({"m": int(ms[i]), "max_rel": rel, "scale": scale})
    t_dense = time.time() - st

    line = {
        "m": [int(m) for m in ms],
        "eval_rtol": REFEREE_EVAL_RTOL,
        "fisher_rtol": REFEREE_FISHER_RTOL,
        "fisher_rel_measure": "max |F - F_dense| / max |F_dense| per m",
        "evals": eval_err,
        "fisher": fisher_err,
        "step_compile_s": t_compile,
        "step_s": t_step,
        "dense_host_s": t_dense,
        "step_memory_analysis": str(mem),
    }
    bad = [e for e in eval_err if e["k"] < 1 or e["max_rel"] > REFEREE_EVAL_RTOL]
    bad += [e for e in fisher_err if e["scale"] == 0 or e["max_rel"] > REFEREE_FISHER_RTOL]
    if bad:
        emit("referee", failed=bad, **line)
        raise RuntimeError(f"referee mismatch: {bad}")
    return line


def phase_ns2(tel_params=NS2, window=NS2_WINDOW, nbands=NS2_BANDS, referee_ms=2,
              cut=KL_CUT) -> dict:
    overrides = precision_overrides()
    if any(v is not None for v in overrides.values()):
        raise RuntimeError(f"per-stage matmul precision overrides set: {overrides}")

    st = time.time()
    s = ns2_setup(tel_params, nbands)
    t_setup = time.time() - st
    tel = s["tel"]
    pos, neg, t_btm_warm, t_btm = btm_window(s, window)

    from driftscan_tpu.parallel import resident

    st = time.time()
    product_window(s, pos, neg, window, cut, bucket=True, max_m=1)
    t_prod_warm = time.time() - st
    st = time.time()
    evals, nmodes, fish = product_window(s, pos, neg, window, cut, bucket=True)
    t_prod = time.time() - st
    facts = check_window(evals, fish, cut)

    # the referee's m-modes: the window's two with the most retained modes
    order = sorted(
        range(len(evals)), key=lambda i: -int((evals[i] > cut).sum())
    )[:referee_ms]
    ms = sorted(window[0] + i for i in order)
    ref = referee(s, pos, neg, window, ms, cut=cut)
    emit("referee", **ref)

    S = min(tel.lmax + 1, 2 * tel.npairs)
    return emit(
        "ns2",
        window=list(window),
        nm=int(window[1] - window[0]),
        nfreq=tel.nfreq, lmax=tel.lmax, mmax=tel.mmax, npairs=tel.npairs,
        npol=tel.num_pol_sky, pencil_n=tel.nfreq * S, nbands=nbands,
        fisher_k=int(resident._FISHER_K[0]),
        precision_overrides=overrides,
        t_setup_s=t_setup,
        t_btm_warmup_s=t_btm_warm, t_btm_s=t_btm,
        t_product_warmup_s=t_prod_warm, t_product_fisher_s=t_prod,
        m_per_s=(window[1] - window[0]) / (t_btm + t_prod),
        **facts,
    )


# ---------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------


def phase_four_cards(devices, tel_params=NS2, window=NS2_WINDOW, nbands=NS2_BANDS,
                     cut=KL_CUT):
    """The ns2 window on an m-mesh over ``devices`` against one device."""
    import numpy as np

    from driftscan_tpu.parallel import mesh as meshmod

    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devices)}")
    s = ns2_setup(tel_params, nbands)
    pos, neg, _, t_btm = btm_window(s, window)
    mesh = meshmod.make_mesh(devices[:4])

    times = {}
    out = {}
    for name, kw in (("one", dict(mbatch=1, bucket=False)), ("mesh", dict(mbatch=4, mesh=mesh))):
        st = time.time()
        product_window(s, pos, neg, window, cut, max_m=4, **kw)
        times[f"t_{name}_warmup_s"] = time.time() - st
        st = time.time()
        out[name] = product_window(s, pos, neg, window, cut, **kw)
        times[f"t_{name}_s"] = time.time() - st

    ev1, _, f1 = out["one"]
    ev4, _, f4 = out["mesh"]
    facts = check_window(ev4, f4, cut)
    # eigenvalues: rtol, with an absolute floor of rtol x the top
    # eigenvalue for the near-zero tail (relative error means nothing there)
    ev_scale = float(np.abs(ev1).max())
    ev_ok = bool(np.allclose(ev4, ev1, rtol=MESH_RTOL, atol=MESH_RTOL * ev_scale))
    retained = ev1 > cut
    ev_rel = float(np.max(np.abs(ev4 - ev1)[retained] / ev1[retained]))
    f_err = float(np.abs(f4 - f1).max() / np.abs(f1).max())
    line = dict(
        window=list(window), devices=len(devices[:4]), rtol=MESH_RTOL,
        evals_allclose=ev_ok, retained_eval_max_rel=ev_rel,
        fisher_rel_err=f_err, fisher_rel_measure="max |F4 - F1| / max |F1|",
        t_btm_s=t_btm, **times, **facts,
    )
    if not ev_ok or f_err > MESH_RTOL:
        emit("four_cards", failed=True, **line)
        raise RuntimeError(
            f"mesh result differs from one card: evals allclose={ev_ok} "
            f"(retained max rel {ev_rel:.3g}), fisher {f_err:.3g}"
        )
    return emit("four_cards", **line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the ns2 window on a 4-card m-mesh against one card",
    )
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))  # the shared dense referee
    import jax

    from driftscan_tpu import backend

    backend.use_compile_cache()
    phase_device()
    print(f"nvidia-smi: {backend.nvidia_smi()}", flush=True)

    if args.four_cards:
        phase_four_cards(jax.devices())
    else:
        phase_ns2()
    print(ok_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
