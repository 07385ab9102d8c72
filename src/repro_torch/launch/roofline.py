"""Roofline analysis from the dry-run records (torch twin of
``repro.launch.roofline``), against one NVIDIA H100 SXM.

Per (arch x shape x mesh) cell of ``launch_artifacts/
dryrun_results_torch.json``:

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw  (None where the
                    record counted no collectives: the port's traces)

Also reports MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per device,
the MODEL_FLOPS/traced ratio, the dominant term, and the roofline fraction
T_ideal / T_bound where T_ideal = max(MODEL_FLOPS/peak, min bytes/HBM_bw)
and T_bound = max(terms).  A ``card`` row that ran carries its measured
median ms.

Hardware constants: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates
at the full 700 W: 989 TFLOP/s bf16, 3.35 TB/s HBM, NVLink 450 GB/s each
way, 80 GB.  A card may be set below 700 W, so every table states the
card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.dryrun import RESULTS_PATH, card_line

PEAK_FLOPS = 989e12          # bf16 dense
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink bytes/s, one direction
FITS_BYTES = 80e9            # device memory
CARD = "H100"


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6*N*D training, 2*N*D per generated token for decode
# ---------------------------------------------------------------------------

def model_params(arch: str) -> Dict[str, float]:
    """Total and active parameter counts from the abstract param tree."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.specs import abstract_params
    from repro_torch.models.transformer import tree_leaves_with_path
    cfg = get_config(arch)
    total = 0
    active = 0
    for path, leaf in tree_leaves_with_path(abstract_params(cfg)):
        name = "/".join(path)
        n = leaf.numel()
        total += n
        if "we_" in name and cfg.moe:                 # routed experts
            frac = min(1.0, cfg.moe.top_k / cfg.moe.n_experts)
            active += n * frac
        elif name.endswith("embed") or "lm_head" in name:
            active += 0      # embedding lookups are not matmul FLOPs
        else:
            active += n
    return {"total": total, "active": active}


def model_flops(arch: str, shape_kind: str, seq_len: int, global_batch: int,
                n_devices: int) -> float:
    """Useful model FLOPs per device for one step."""
    mp = model_params(arch)
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * mp["active"] * tokens / n_devices
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * mp["active"] * tokens / n_devices
    # decode: one token per sequence
    return 2.0 * mp["active"] * global_batch / n_devices


def _n_units(arch: str) -> int:
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    per = 2 if (cfg.moe and cfg.moe.moe_every == 2) else 1
    return cfg.n_layers // per


def _loop_corrected(base: float, d1: float, d2: float, units: int) -> float:
    """outside + units*body, from depth-1/2 probes (body = d2-d1, outside =
    d1-body).  The reference needs it because XLA counts a while-loop body
    once; the port's traces run every layer, so it gives back ``base``."""
    body = max(d2 - d1, 0.0)
    outside = max(d1 - body, 0.0)
    return outside + units * body


def _ssm_scan_terms(arch: str, kind: str, seq_len: int, global_batch: int,
                    ndev: int):
    """Analytic flops/bytes of the chunked selective scan: ~6 array passes
    over (B, S, Din, N) fp32, ~10 flops/element.  The FLOP counter counts
    no elementwise op, so the flops are added to every record; the bytes
    only to a record whose byte count did not trace every op (the
    reference's)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if cfg.ssm is None or kind == "decode":
        return 0.0, 0.0
    d_in = cfg.ssm.expand * cfg.d_model
    n = cfg.ssm.d_state
    elems = (seq_len * global_batch) * d_in * n / ndev  # per layer
    return 10.0 * elems * cfg.n_layers, 6.0 * 4.0 * elems * cfg.n_layers


def _model_min_bytes(arch: str, kind: str, seq_len: int, global_batch: int,
                     ndev: int) -> float:
    """Lower bound on bytes/step/device: touch active params (bf16) once,
    plus (decode) read the KV/state cache once."""
    mp = model_params(arch)
    param_bytes = 2.0 * mp["active"] / ndev
    if kind != "decode":
        return param_bytes
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.specs import abstract_cache
    from repro_torch.models.transformer import tree_leaves
    cache = abstract_cache(get_config(arch), global_batch, seq_len)
    cache_bytes = sum(leaf.numel() * leaf.element_size()
                      for leaf in tree_leaves(cache))
    return param_bytes + cache_bytes / ndev


def analyze_cell(key: str, rec: dict, probes: Optional[dict] = None
                 ) -> Optional[dict]:
    if rec.get("status") != "OK":
        return None
    arch, shape, mesh, variant = key.split("|")
    from repro_torch.models.config import shape_by_name
    sh = shape_by_name(shape)
    ndev = rec["n_devices"]
    flops_dev = rec["cost"]["flops_per_device"]
    bytes_dev = rec["cost"]["bytes_accessed_per_device"]
    coll = rec["collectives"]
    coll_dev = None if coll is None else coll["total_bytes"]
    corrected = False
    if probes:
        pfx = "probe" if variant == "base" else f"{variant}-probe"
        # the row's own mesh's probes; else the single mesh's, as the
        # reference reads them for every mesh
        at = mesh if f"{arch}|{shape}|{mesh}|{pfx}-d1" in probes \
            else "single"
        d1 = probes.get(f"{arch}|{shape}|{at}|{pfx}-d1")
        d2 = probes.get(f"{arch}|{shape}|{at}|{pfx}-d2")
        if d1 and d2 and d1.get("status") == "OK" \
                and d2.get("status") == "OK":
            units = _n_units(arch)
            flops_dev = _loop_corrected(
                flops_dev, d1["cost"]["flops_per_device"],
                d2["cost"]["flops_per_device"], units)
            bytes_dev = _loop_corrected(
                bytes_dev, d1["cost"]["bytes_accessed_per_device"],
                d2["cost"]["bytes_accessed_per_device"], units)
            if coll_dev is not None:
                coll_dev = _loop_corrected(
                    coll_dev, d1["collectives"]["total_bytes"],
                    d2["collectives"]["total_bytes"], units)
            corrected = True
    sf, sb = _ssm_scan_terms(arch, rec["kind"], sh.seq_len,
                             sh.global_batch, ndev)
    flops_dev += sf
    if not rec["cost"].get("bytes_traced_per_op"):
        bytes_dev += sb
    t_comp = flops_dev / PEAK_FLOPS
    t_mem = bytes_dev / HBM_BW
    t_coll = None if coll_dev is None else coll_dev / LINK_BW
    mf = model_flops(arch, rec["kind"], sh.seq_len, sh.global_batch, ndev)
    mb = _model_min_bytes(arch, rec["kind"], sh.seq_len, sh.global_batch,
                          ndev)
    t_ideal = max(mf / PEAK_FLOPS, mb / HBM_BW)
    terms = {"compute": t_comp, "memory": t_mem}
    if t_coll is not None:
        terms["collective"] = t_coll
    dominant = max(terms, key=terms.get)
    t_bound = terms[dominant]
    mem = rec["memory"]
    measured = rec.get("measured", {}).get("ms")
    return {
        "key": key, "arch": arch, "shape": shape, "mesh": mesh,
        "variant": variant, "kind": rec["kind"], "n_devices": ndev,
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_device": mf,
        "hlo_flops_per_device": flops_dev,
        "useful_fraction": mf / flops_dev if flops_dev > 0 else 0.0,
        "roofline_fraction": t_ideal / t_bound if t_bound > 0 else 0.0,
        "peak_bytes_per_device": mem["peak_bytes"],
        "peak_is_lower_bound": bool(mem.get("peak_is_lower_bound", False)),
        "fits_80g": mem["peak_bytes"] < FITS_BYTES,
        "loop_corrected": corrected,
        "t_ideal_s": t_ideal,
        "measured_ms": measured,
        "measured_vs_bound": (t_bound * 1e3 / measured) if measured
        else None,
    }


def analyze_all(variant: str = "base") -> list:
    with open(RESULTS_PATH) as f:
        results = json.load(f)
    probes = {k: v for k, v in results.items() if "|probe-" in k}
    rows = []
    for key, rec in sorted(results.items()):
        if not key.endswith("|" + variant) or key.startswith("amg-"):
            continue
        row = analyze_cell(key, rec, probes)
        if row:
            rows.append(row)
    return rows


def _s(t) -> str:
    return "-" if t is None else f"{t:.2e}"


def markdown_table(rows: list) -> str:
    hdr = ("| arch | shape | mesh | kind | compute s | memory s | coll s | "
           "dominant | useful | roofline | peak GiB | fits 80G | card ms |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        peak = r["peak_bytes_per_device"] / 2**30
        ms = r["measured_ms"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['kind']} | "
            f"{_s(r['t_compute_s'])} | {_s(r['t_memory_s'])} | "
            f"{_s(r['t_collective_s'])} | **{r['dominant']}** | "
            f"{r['useful_fraction']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{'>=' if r['peak_is_lower_bound'] else ''}{peak:.1f} | "
            f"{'Y' if r['fits_80g'] else 'N'} | "
            f"{'-' if ms is None else f'{ms:.3f}'} |\n")
    return "".join(out)


def constants_line(card) -> str:
    return (f"constants: NVIDIA H100 SXM data sheet, dense, 700 W: "
            f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s "
            f"HBM, {LINK_BW / 1e9:.0f} GB/s NVLink each way, "
            f"{FITS_BYTES / 1e9:.0f} GB; card: {card or 'none'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device whose card the table names "
                         "(default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else None
    if card is not None and CARD not in card:
        raise RuntimeError(f"roofline: the constants are an {CARD}'s; this "
                           f"card is {card!r}")
    rows = analyze_all(args.variant)
    print(constants_line(card))
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(markdown_table(rows))
        worst = sorted((r for r in rows if r["mesh"] == "single"),
                       key=lambda r: r["roofline_fraction"])
        if worst:
            print("\nworst roofline fraction (single-pod):")
            for r in worst[:5]:
                print(f"  {r['arch']} {r['shape']}: "
                      f"{r['roofline_fraction']:.3f} ({r['dominant']})")
        ran = [r for r in rows if r["measured_ms"] is not None]
        if ran:
            print(f"card rows ({card or 'no card'}): measured ms against "
                  f"the bound")
            for r in ran:
                print(f"  {r['arch']} {r['shape']}: {r['measured_ms']:.3f} "
                      f"ms, bound {max(r['t_compute_s'], r['t_memory_s']) * 1e3:.3f} ms "
                      f"({r['dominant']}), ideal {r['t_ideal_s'] * 1e3:.3f} "
                      f"ms")
    print(json.dumps({"card": card, "rows": len(rows),
                      "measured": {r["key"]: r["measured_ms"] for r in rows
                                   if r["measured_ms"] is not None}}))
    return 0


cli = main     # the command line's entry, as every twin names it


if __name__ == "__main__":
    raise SystemExit(main())
