#!/usr/bin/env python
"""Benchmark: m-modes/s for BTM + SVD + KL + Fisher product generation.

Runs the hot phases of the pipeline on the default device:

1. BTM generation: batched beam maps + spherical harmonic transform for
   every (freq, baseline) unit of a mid-scale unpolarised cylinder;
2. the batched per-m product step: SVD compression + KL eigenproblem
   for every m-mode (driftscan_tpu.parallel.resident);
3. the same product pass with the quadratic-estimator Fisher fused in.

Prints ONE JSON line: {"metric", "value", "unit", "detail"}; ``detail``
names the device the numbers were taken on (platform, device kind and
count, and on a GPU the nvidia-smi name and power limit).  A failing
phase raises: no line is printed for a run that did not finish.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

from driftscan_tpu import backend

backend.use_compile_cache()

SCALE = os.environ.get("BENCH_SCALE", "full")


def build_telescope():
    from driftscan_tpu.telescope import cylinder

    if SCALE == "small":
        params = dict(
            num_freq=4,
            freq_start=100.0,
            freq_end=110.0,
            freq_mode="edge",
            num_cylinders=2,
            cylinder_width=3.0,
            num_feeds=3,
            feed_spacing=1.0,
            tsys=50.0,
            single_precision=True,
        )
    else:
        # Mid-scale cylinder: mmax ~ 230, 8 freq channels, 67 baselines.
        params = dict(
            num_freq=8,
            freq_start=400.0,
            freq_end=450.0,
            freq_mode="edge",
            num_cylinders=2,
            cylinder_width=12.0,
            num_feeds=8,
            feed_spacing=0.6,
            tsys=50.0,
            single_precision=True,
        )
    return cylinder.UnpolarisedCylinderTelescope.from_config(params)


def build_pol_telescope():
    """Small polarised cylinder for the device's polarised leg.

    Exercises the npol=4 triple-SVD polarisation filtering
    (reference beamtransfer.py:730-929) end to end on the device at a
    scale that adds ~a minute to the bench, not tens of minutes.
    """
    from driftscan_tpu.telescope import cylinder

    return cylinder.PolarisedCylinderTelescope.from_config(
        dict(
            num_freq=4,
            freq_start=400.0,
            freq_end=450.0,
            freq_mode="edge",
            num_cylinders=2,
            cylinder_width=6.0,
            num_feeds=4,
            feed_spacing=1.5,
            tsys=50.0,
            single_precision=True,
        )
    )


# Phase/warm-up timings accumulated for the JSON detail block.
_PHASES = {}


def _covariances(tel):
    from driftscan_tpu.core import skymodel

    npol = tel.num_pol_sky
    cl_s = skymodel.im21cm_model(tel.lmax, tel.frequencies, npol)
    cl_n = skymodel.foreground_model(tel.lmax, tel.frequencies, npol)

    noisew = np.stack(
        [
            np.concatenate([w, w])
            for w in (
                tel.noisepower(np.arange(tel.npairs), fi).flatten() ** -0.5
                for fi in range(tel.nfreq)
            )
        ]
    )
    npower = np.stack(
        [
            np.concatenate([p, p])
            for p in (
                tel.noisepower(np.arange(tel.npairs), fi).flatten()
                for fi in range(tel.nfreq)
            )
        ]
    )
    # covariances stay f64: factor_cl's rank compaction measures the
    # numerical rank at f64 resolution (an early f32 cast raises the
    # noise floor above the cut and silently disables compaction); the
    # factors themselves are cast to f32 downstream.
    return cl_s, cl_n, noisew.astype(np.float32), npower.astype(np.float32)


def _log(msg):
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.time()


def resident_phases(tel):
    """Device-resident BTM + product phases; returns (t_btm, t_prod, state).

    Each timed region ends in ``block_until_ready`` (the product pass
    returns host spectra, which already waits for the device).
    """
    from driftscan_tpu.parallel import mstep, resident

    mbatch = resident._auto_mbatch(tel)
    _PHASES.setdefault("mbatch", int(mbatch))

    cl_s, cl_n, noisew, _ = _covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)

    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    _log("BTM warm-up/compile pass...")
    wt = time.time()
    pos, neg = jax.block_until_ready(resident.btm_resident(tel, blg, fig))
    _PHASES.setdefault("t_btm_warmup_s", round(time.time() - wt, 2))

    _log("BTM steady pass...")
    st = time.time()
    pos, neg = jax.block_until_ready(resident.btm_resident(tel, blg, fig))
    t_btm = time.time() - st

    nm = tel.mmax + 1

    # QR foreground whitening + full signal-side Gram levels.  The
    # rank-capped quick-look (BENCH_SIG_K_CAP) trades ~6e-3 bias for speed.
    sig_k_cap = int(os.environ.get("BENCH_SIG_K_CAP", "0"))

    _log(f"product warm-up compile (mbatch={mbatch}, sig_k_cap={sig_k_cap})...")
    wt = time.time()
    resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=mbatch,
        max_m=min(mbatch, nm), sig_k_cap=sig_k_cap,
    )
    _PHASES.setdefault("t_product_warmup_s", round(time.time() - wt, 2))

    _log("product steady pass...")
    st = time.time()
    evals, nmodes = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=mbatch, max_m=nm,
        sig_k_cap=sig_k_cap,
    )
    t_prod = time.time() - st

    if not np.isfinite(evals).all():
        raise RuntimeError("non-finite KL eigenvalues in bench product phase")
    return t_btm, t_prod, (pos, neg, ls, lf, noisew)


def _fisher_bands(tel, nbands=4):
    """Real polar-annulus band angular power spectra (host, once).

    The same construction as PSEstimation.genbands/make_clzz (reference
    psestimation.py:291-347), shrunk to ``nbands`` uniform k-bands.
    """
    from driftscan_tpu.core import psestimation as psmod
    from driftscan_tpu.core import skymodel

    edges = np.linspace(0.02, 0.25, nbands + 1)
    cr = skymodel.Corr21cm()
    cl = []
    for ks, ke in zip(edges[:-1], edges[1:]):
        ind = psmod.bandfunc_2d_polar(ks, ke, 0.0, np.pi / 2.0)
        crt = skymodel.Corr21cm(
            ps=(lambda f: (lambda k, mu: cr.ps_vv(k) * f(k, mu)))(ind),
            redshift=1.5,
        )
        crt.ps_2d = True
        cl.append(
            skymodel.im21cm_model(
                tel.lmax, tel.frequencies, 1, cr=crt, temponly=True
            )
        )
    return np.asarray(cl, dtype=np.float32)  # (nbands, L, F, F)


def _product_flops(tel, nm):
    """Analytic FLOP count of the product phase (per the QR pencil design).

    Per m (n = ndof, K = nl*npf real factor columns, on 2x real
    embeddings): QR of (2(K+n), 2n); two triangular solves; one Gram +
    one 2n eigh (QDWH ~ 30 (2n)^3) per deflation level (adaptive: 1);
    triple SVD and beam build are negligible.
    """
    nl = tel.lmax + 1
    npf = tel.num_pol_sky * tel.nfreq
    n = tel.nfreq * min(nl, 2 * tel.npairs) * tel.num_pol_sky
    K = nl * npf
    n2, k2 = 2 * n, 2 * K
    qr = 2 * (k2 + n2) * n2**2 - (2 / 3) * n2**3
    solves = 2 * n2**2 * k2
    gram = 2 * n2**2 * k2
    eigh = 30 * n2**3
    return nm * (qr + solves + gram + eigh)


def main():
    dev = backend.device_record()

    tel = build_telescope()
    nm = tel.mmax + 1
    nfb_total = tel.npairs * tel.nfreq
    _log(f"telescope ready: nm={nm} nfb={nfb_total} device={dev}")

    t_btm, t_prod, state = resident_phases(tel)
    _log(f"BTM phase: {t_btm:.1f}s; product phase: {t_prod:.1f}s")
    mm_per_sec = nm / (t_btm + t_prod)

    # Fisher leg, fused into the product dispatch: the factored band
    # covariances ride the same batch as the KL solve, so the
    # eigenvectors never leave the device.  The headline spans all four
    # phases (BTM+SVD+KL+Fisher): t_btm + t_fused.
    from driftscan_tpu.parallel import mstep, resident

    pos, neg, ls, lf, noisew = state
    clb = _fisher_bands(tel)
    band_lt = mstep.band_factor_table(
        iter(clb), out_dtype=np.float32, rank_rtol=1e-9
    )
    mb = resident._auto_mbatch(tel)
    fkw = dict(band_lt=band_lt, ps_threshold=0.1)
    _log("fused product+fisher warm-up compile...")
    wt = time.time()
    resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=mb, max_m=min(mb, nm), **fkw,
    )
    _PHASES.setdefault("t_fisher_warmup_s", round(time.time() - wt, 2))
    _log("fused product+fisher steady pass...")
    st = time.time()
    _ev, _nm, fish = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=mb, **fkw,
    )
    t_fused = time.time() - st
    if not np.isfinite(fish).all():
        raise RuntimeError("non-finite fused Fisher")
    t_f = max(t_fused - t_prod, 0.0)  # incremental Fisher cost
    with_fisher = nm / (t_btm + t_fused)
    _log(
        f"fused product+fisher: {t_fused:.1f}s for {nm} m "
        f"(fisher increment {t_f:.1f}s)"
    )
    del state, pos, neg

    # Polarised leg (BENCH_POL=0 disables): a small polarised cylinder
    # through the same resident BTM+product path, so the npol=4
    # triple-SVD filtering is measured on the device.
    pol_detail = {}
    if os.environ.get("BENCH_POL", "1") == "1" and dev["platform"] != "cpu":
        tel_p = build_pol_telescope()
        nm_p = tel_p.mmax + 1
        _log(
            f"polarised leg: nm={nm_p} nfb={tel_p.npairs * tel_p.nfreq} "
            f"npol={tel_p.num_pol_sky}"
        )
        t_btm_p, t_prod_p, state_p = resident_phases(tel_p)
        del state_p
        pol_detail = {
            "pol_m_per_s": round(nm_p / (t_btm_p + t_prod_p), 3),
            "pol_nm": nm_p,
            "pol_t_btm_s": round(t_btm_p, 2),
            "pol_t_product_s": round(t_prod_p, 2),
        }

    product_tflops = _product_flops(tel, nm) / t_prod / 1e12
    out = {
        "metric": "m-modes/sec/chip (BTM+SVD+KL+Fisher)",
        "value": round(with_fisher, 3),
        "unit": "m-modes/s",
        "detail": {
            **dev,
            "telescope": "unpolarised cylinder",
            "nm": nm,
            "nfb": nfb_total,
            # steady-state phase walls (post warm-up)
            "t_btm_s": round(t_btm, 2),
            "t_product_s": round(t_prod, 2),
            "t_product_fisher_fused_s": round(t_fused, 2),
            "t_fisher_s": round(t_f, 2),
            "m_per_s_btm_svd_kl": round(mm_per_sec, 3),
            # analytic product-phase flop rate (see _product_flops)
            "product_tflops": round(product_tflops, 3),
            **pol_detail,
            # compile/warm-up split (cold unless the persistent
            # compilation cache is populated)
            **_PHASES,
        },
    }
    # Durable copy of the record (atomic): downstream tooling reads the
    # file instead of scraping the last stdout line.
    rec_path = os.environ.get(
        "BENCH_RECORD_PATH",
        os.path.join(backend.REPO_ROOT, "doc", "bench_record.json"),
    )
    with open(rec_path + ".tmp", "w") as f:
        json.dump(out, f, indent=1)
    os.replace(rec_path + ".tmp", rec_path)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
