"""Share of one class of barrier phases in the interior-point kernel that the
cell's call launches (K1 at batch 1, K2 for a batch), in % of the kernel's
whole cycles summed over its blocks: the program's section timers (the
``ipm_sections`` record of the entry's graph stats, which the
``legged_ipm`` family adds from ``ops/cuda_ipm_riccati.phase_cycles``: a
timed instantiation of the kernel launched on the call's QP after the
window). The classes are the kernel's ``PHASE_CLASSES``: ``inverse``,
``products``, ``sweeps``, ``gradients``, ``bulk``, ``stage_loads``,
``elementwise``.

``ipm_section_pct.<class>.<cell kind>``; the kind only tells the cells
apart."""


def read(ctx, arg):
    rec = (ctx.graph_stats or {}).get("ipm_sections")
    cls = arg.partition(".")[0]
    if not rec or cls not in rec.get("share", {}):
        return None
    share = rec["share"]
    if cls == next(iter(share)):  # one line per run, beside the first class
        print(f"# ipm_section_pct: {rec.get('entry')} over "
              f"{rec['blocks']} blocks, the {len(share)} classes sum to "
              f"{100.0 * sum(share.values()):.2f} %; timed launch "
              f"{rec['timed_ms']:.4f} ms, untimed {rec['untimed_ms']:.4f} "
              "ms", flush=True)
    return 100.0 * share[cls]
