"""Every rank's spans and counters of the mesh's traced job, for the
mesh's per-layer readers.

loops/mesh_render.py gathers each rank's record of its traced job
(statmc_tpu_torch/spans.py: its spans, and its counters' growth in the
job) into ctx["rank_spans"], in rank order.  The arithmetic:

- ``collective_ns``: a rank's host ns in the collectives' spans
  ``mesh.<kind>`` (parallel/shard.py ``Mesh.timed``: from the rank's
  arrival at the collective to its device's synchronize after it);
- ``wait_ns``: a rank's wait for slower peers: at each collective, the
  latest arrival among the ranks that take part (the ends of their spans
  ``mesh.arrive.<kind>``, whose attribute ``ranks`` names them; the
  ranks share one host clock) less its own, the j-th collective of a
  kind on one rank matched with the j-th on the others;
- ``bytes_total``: the counters ``mesh.bytes.<kind>``, over kinds and
  ranks.

Each gives None where a rank recorded no span (no profiler ran: the
CPU) or the program records none of them.  The first reading of a run
adds to ctx["notes"], which run.py prints on standard error, each
rank's seconds in the traced job's iterations, renders, denoises,
collectives and waits.
"""
from __future__ import annotations

from . import spans as S

ARRIVE = "mesh.arrive."


def _ranks(ctx):
    snaps = ctx.get("rank_spans")
    if not snaps or any(s is None or not s["spans"] for s in snaps):
        return None
    if not ctx.get("_mesh_noted"):
        ctx["_mesh_noted"] = True
        waits = wait_ns(ctx) or [0] * len(snaps)
        coll = collective_ns(ctx) or [0] * len(snaps)
        rows = []
        for rank, snap in enumerate(snaps):
            by = {n: sum(S.duration_ns(s) for s in snap["spans"]
                         if s["name"] == n)
                  for n in ("iteration", "render", "denoise")}
            rows.append(f"rank {rank}: " + ", ".join(
                f"{n} {v / 1e9:.3f}" for n, v in by.items())
                + f", collectives {coll[rank] / 1e9:.3f}, wait "
                f"{waits[rank] / 1e9:.3f}")
        ctx.setdefault("notes", []).append(
            "mesh by rank (s of the traced job): " + "; ".join(rows))
    return snaps


def collective_ns(ctx):
    """[host ns in mesh.<kind> spans] a rank."""
    snaps = _ranks(ctx)
    if snaps is None:
        return None
    out = [sum(S.duration_ns(s) for s in snap["spans"]
               if s["name"].startswith("mesh.")
               and not s["name"].startswith(ARRIVE)) for snap in snaps]
    return out if any(out) else None


def wait_ns(ctx):
    """[ns waited for slower peers] a rank."""
    snaps = _ranks(ctx)
    if snaps is None:
        return None
    arrivals = {}  # (kind, j) -> {rank: (arrival ns, ranks taking part)}
    for rank, snap in enumerate(snaps):
        seen = {}
        for s in snap["spans"]:
            if s["name"].startswith(ARRIVE) and s["end_ns"] is not None:
                kind = s["name"][len(ARRIVE):]
                j = seen[kind] = seen.get(kind, -1) + 1
                arrivals.setdefault((kind, j), {})[rank] = (
                    s["end_ns"], s["attrs"]["ranks"])
    if not arrivals:
        return None
    out = [0] * len(snaps)
    for at in arrivals.values():
        for rank, (t, peers) in at.items():
            out[rank] += max(at[q][0] for q in peers if q in at) - t
    return out


def bytes_total(ctx):
    """The mesh.bytes.<kind> counters over kinds and ranks."""
    snaps = _ranks(ctx)
    if snaps is None:
        return None
    keys = [k for snap in snaps for k in snap["counters"]
            if k.startswith("mesh.bytes.")]
    if not keys:
        return None
    return sum(v for snap in snaps for k, v in snap["counters"].items()
               if k.startswith("mesh.bytes."))
