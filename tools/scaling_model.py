"""Per-device collective bytes of each multi-device schedule.

The byte volume each device sends per step, as a function of the device
count C, for every config's schedules: analytic formulas anchored to and
guarded against the partitioned HLO byte counts (parallel/comm.py;
tests/test_scaling_model.py pins formula == HLO at the virtual-mesh-
measurable shape so the model cannot silently drift from the shipped
code).  Turning bytes into a scaling efficiency needs the single-card
step time and the interconnect's measured collective rate; both come
from runs on the cards (``python chip_smoke.py --four-cards`` prints the
step time and the collective bytes of each schedule).

A dp axis on top of any schedule moves ZERO collective bytes
(tests/test_parallel_guards.py pins this), so the rows below are the
latency slice (limb or coeff axis) only.

Byte formulas per schedule (per device per step; b = ciphertext batch
per latency slice, n_ct/L/nsp/N from the config's chain):

- explicit one-gather (parallel/keyswitch_sp.py):
    bytes = b * (n_ct + 2) * N * 8, 2 collectives
  (ONE all-gather of the power-basis target + ONE q_last all-reduce —
  PERF.md comm table row 1280 KiB at b=4, n_ct=8, N=4096: exact match.)
  Independent of C: the gathered target is the whole tensor.

- GSPMD (XLA-chosen partitioning of the in-core step):
    bytes ~= b * kappa * (L + nsp) * N * 8, kappa fitted at the two
  measured anchors ((dp2,limb4): 5632 KiB at b=4; (1,8): 11008 KiB at
  b=8 -> kappa ~ 4.3-4.4 per (L+nsp) row) — GSPMD's gathered digit /
  permuted accumulator traffic does not shrink with C.

- coefficient-sharded (parallel/pipeline_csp.py):
    bytes = n_tr * b * rows_eff * (N / C) * 8,  n_tr = 16 transposes,
  rows_eff ~= L + nsp + 0.5 (fitted: 10.5 at the L=8+2sp anchor where
  the HLO measures 10752 KiB at C=4, b=8, N=4096).  Counting follows
  comm.py's convention (all_to_all RESULT bytes; wire bytes are
  (C-1)/C of that).  Shrinks as 1/C — the deep-N layout.

- BEHZ five-gather (parallel/behz_sp.py, the BFV configs):
    bytes = 11 * b * n_ct * N * 8, 5 collectives
  (2 operand extends of [b, 2, n_ct, N] + fast_floor and fastbconv_sk
  gathers of [b, 3, n_ct, N] + the relin target [b, n_ct, N]: 11
  polynomial planes — tests/test_scaling_model.py pins formula == HLO
  exactly).  Independent of C; feasible for C dividing n_ct (= n_B).

- GSPMD-BFV (XLA partitioning of build_bfv_mul_relin):
    bytes ~= b * kappa_bfv * (n_ct + nsp) * N * 8, kappa_bfv ~ 9.0
  fitted at the PERF.md anchor (10.1 MiB at N=2048, n_ct=8, nsp=1,
  b=8, limb=4) and guarded within 25% by test_scaling_model.py.

Limb sharding (explicit or GSPMD) is capped at C = n_ct for BFV — the
table prints n/a beyond it; a dp axis extends the device count past
that point at zero collective bytes.

Usage: python tools/scaling_model.py   (prints the byte table)
"""

# BASELINE.md's configs at batch 128.  n_ct = first-level ciphertext limb
# count, nsp = special primes.  "schedules" names the rows printed for
# the config; "max_limb" caps the feasible limb-shard width.
CONFIGS = {
    "config 1 (BFV mul+relin, N=4096)": dict(
        b=128, N=4096, n_ct=2, nsp=1,
        schedules=("GSPMD-BFV (XLA-chosen)", "BEHZ five-gather (behz_sp)"),
        max_limb=2),
    "config 2 (BFV rotate_rows, N=8192)": dict(
        b=128, N=8192, n_ct=4, nsp=1,
        schedules=("GSPMD-BFV (XLA-chosen)", "explicit one-gather"),
        max_limb=4),
    "config 3 (BFV mul+relin+chain, N=8192)": dict(
        b=128, N=8192, n_ct=4, nsp=1,
        schedules=("GSPMD-BFV (XLA-chosen)", "BEHZ five-gather (behz_sp)"),
        max_limb=4),
    "config 4 (CKKS mul+relin+rescale, N=16384)": dict(
        b=128, N=16384, n_ct=5, nsp=1),
    "config 5 (deep CKKS poly4+rot, N=32768)": dict(
        b=128, N=32768, n_ct=8, nsp=1),
}

GSPMD_KAPPA = 4.4     # fitted: see tests/test_scaling_model.py anchors
GSPMD_KAPPA_BFV = 9.0  # fitted at the behz GSPMD anchor (PERF.md 10.1 MiB)
CSP_N_TR = 16
CSP_ROWS_PAD = 0.5


def bytes_explicit(b, n_ct, nsp, N, C):
    return b * (n_ct + 2) * N * 8, 2


def bytes_gspmd(b, n_ct, nsp, N, C):
    # dozens of collectives in the measured profiles; 20 is the anchor's
    # order of magnitude (2 all-reduce + 10+ permutes per component)
    return b * GSPMD_KAPPA * (n_ct + nsp) * N * 8, 20


def bytes_gspmd_bfv(b, n_ct, nsp, N, C):
    # the BEHZ step's gathered extension traffic: 1 all-reduce + ~42
    # collective-permutes in the measured profile
    return b * GSPMD_KAPPA_BFV * (n_ct + nsp) * N * 8, 43


def bytes_csp(b, n_ct, nsp, N, C):
    rows_eff = n_ct + nsp + CSP_ROWS_PAD
    return CSP_N_TR * b * rows_eff * (N / C) * 8, CSP_N_TR


def bytes_behz(b, n_ct, nsp, N, C):
    # 5 tiled all-gathers totalling 11 polynomial planes of [b, n_ct, N]:
    # 2 operand extends (2 planes each), fast_floor + fastbconv_sk
    # (3 planes each: the size-3 convolution output), relin target (1)
    return 11 * b * n_ct * N * 8, 5


SCHEDULES = {
    "GSPMD (XLA-chosen)": bytes_gspmd,
    "explicit one-gather": bytes_explicit,
    "coeff-sharded (pipeline_csp)": bytes_csp,
    "GSPMD-BFV (XLA-chosen)": bytes_gspmd_bfv,
    "BEHZ five-gather (behz_sp)": bytes_behz,
}

# rows printed for configs that don't name their own schedule set
DEFAULT_SCHEDULES = (
    "GSPMD (XLA-chosen)", "explicit one-gather",
    "coeff-sharded (pipeline_csp)",
)


def main():
    chips = [2, 4, 8]
    print("| Config | Schedule | " +
          " | ".join(f"MiB/device @ {c}" for c in chips) +
          " | collectives |")
    print("|---|---|" + "---|" * (len(chips) + 1))
    for cname, cfg in CONFIGS.items():
        max_limb = cfg.get("max_limb", max(chips))
        for sname in cfg.get("schedules", DEFAULT_SCHEDULES):
            fn = SCHEDULES[sname]
            cells, n_coll = [], 0
            for c in chips:
                if c > max_limb:
                    cells.append("n/a (dp)")
                    continue
                byts, n_coll = fn(cfg["b"], cfg["n_ct"], cfg["nsp"],
                                  cfg["N"], c)
                cells.append(f"{byts / 2 ** 20:.1f}")
            print(f"| {cname} | {sname} | " + " | ".join(cells) +
                  f" | {n_coll} |")


if __name__ == "__main__":
    main()
