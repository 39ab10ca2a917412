"""Client-side software merge of group partials (port of the groups half of
`repro/core/offload.py`).

A groups-kind response is a compact partial: the node's bucket table plus
the packed collision rows its hash table could not hold (paper §5.4). The
client folds any number of such partials — the overflow of one node, or
the partials of several — into exact per-key totals with ONE segment
reduce on the partials' device (`merge_groups_device`), the designed sync
point of the group path.

The JAX module also runs pipelines over a device-sharded pool and merges
rows-kind and mask-kind partials of cluster scatter-gather; those come
with the cluster slice of the port (ROADMAP.md queue 1, slice 6).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import operators as op_ir
from repro_torch.core.pipeline import PipelineResult, compile_pipeline
from repro_torch.core.table import FTable
from repro_torch.kernels import ref as kref

# group-merge pad key: sorts past every real key (|key| < 2^24 at ingest),
# the bucket sentinel (int32 min) and the drop key (int32 min + 1)
_PAD_KEY = 2**31 - 1
_BIG = kref.F32_BIG
_CLUSTER_SLICE = ("rows-kind and mask-kind partial merges are not ported "
                  "yet: they come with ROADMAP.md queue 1, slice 6 (cluster)")


def _segment_merge_groups(keys, cnt, sums, mins, maxs):
    """Device-side merge of concatenated group partials.

    keys (M,) int32 (invalid entries pre-masked to _PAD_KEY); cnt (M,)
    int32; sums/mins/maxs (M, V) f32. Stable-sorts by key and reduces each
    key's segment in one segmented scan. Returns per-row (sorted_keys,
    end_mask, count, sum, min, max); each key's totals sit at its
    segment-end row (select with end_mask)."""
    order = torch.sort(keys, stable=True).indices
    k = keys[order]
    one = torch.ones((min(int(k.shape[0]), 1),), dtype=torch.bool,
                     device=k.device)
    flags = torch.cat([one, k[1:] != k[:-1]])
    cs, ss, mns, mxs = kref.segmented_reduce(
        sums[order], mins[order], maxs[order], flags, counts=cnt[order])
    end = torch.cat([flags[1:], one])
    return k, end, cs, ss, mns, mxs


# farlint: finalize-boundary (the group merge IS the designed sync point)
def merge_groups_device(groups: "list[dict]", drop: "int | None") -> dict:
    """Concatenate the partials' (bucket entries + overflow rows) and
    segment-reduce them on the bucket tables' device; only the compact
    per-key totals cross back to the host dict {key: [count, sum, min,
    max]}. A collision row is a (key, count=1, sum=min=max=value) partial
    aggregate."""
    drop_val = _PAD_KEY if drop is None else int(drop)
    dev = torch.as_tensor(groups[0]["bucket_keys"]).device
    ks, cs, ss, mns, mxs = [], [], [], [], []
    for g in groups:
        bk = torch.as_tensor(g["bucket_keys"]).to(dev, torch.int32)
        cnt = torch.as_tensor(g["count"]).to(dev, torch.int32)
        bsum = torch.as_tensor(g["sum"]).to(dev, torch.float32)
        bad = (bk == kref.KEY_SENTINEL) | (cnt <= 0) | (bk == drop_val)
        badv = bad[:, None]
        ks.append(torch.where(bad, _PAD_KEY, bk))
        cs.append(torch.where(bad, 0, cnt))
        ss.append(torch.where(badv, 0.0, bsum))
        mns.append(torch.where(badv, _BIG, torch.as_tensor(g["min"]).to(
            dev, torch.float32)))
        mxs.append(torch.where(badv, -_BIG, torch.as_tensor(g["max"]).to(
            dev, torch.float32)))
        ok = torch.as_tensor(np.asarray(g["ovf_keys"], np.int32)).to(dev)
        if ok.shape[0]:
            ov = torch.as_tensor(np.asarray(g["ovf_vals"], np.float32)).to(
                dev)
            obad = ok == drop_val
            obadv = obad[:, None]
            ks.append(torch.where(obad, _PAD_KEY, ok))
            cs.append(torch.where(obad, 0, 1).to(torch.int32))
            ss.append(torch.where(obadv, 0.0, ov))
            mns.append(torch.where(obadv, _BIG, ov))
            mxs.append(torch.where(obadv, -_BIG, ov))
    m = sum(int(a.shape[0]) for a in ks)
    pad = op_ir.pow2_bucket(m) - m      # the reference's padded shape
    v = int(ss[0].shape[1])
    if pad:
        ks.append(torch.full((pad,), _PAD_KEY, dtype=torch.int32, device=dev))
        cs.append(torch.zeros((pad,), dtype=torch.int32, device=dev))
        ss.append(torch.zeros((pad, v), dtype=torch.float32, device=dev))
        mns.append(torch.full((pad, v), _BIG, dtype=torch.float32,
                              device=dev))
        mxs.append(torch.full((pad, v), -_BIG, dtype=torch.float32,
                              device=dev))
    k, end, tc, tsum, tmin, tmax = _segment_merge_groups(
        torch.cat(ks).to(torch.int32), torch.cat(cs).to(torch.int32),
        torch.cat(ss), torch.cat(mns), torch.cat(mxs))
    sel = (end & (k != _PAD_KEY)).cpu().numpy()
    uk = k.cpu().numpy()[sel]
    uc = tc.cpu().numpy()[sel]
    us = tsum.cpu().numpy()[sel]
    umn = tmin.cpu().numpy()[sel]
    umx = tmax.cpu().numpy()[sel]
    return {int(key): [int(c), s, mn, mx]
            for key, c, s, mn, mx in zip(uk.tolist(), uc.tolist(),
                                         us, umn, umx)}


def _merge(schema: FTable, pipeline: tuple,
           partials: list[PipelineResult]) -> PipelineResult:
    """Client-side software merge of groups-kind partials (per node, or a
    node's own overflow): bucket tables and collision rows fold in one
    device-side segment reduce. The rows-kind and mask-kind merges of
    cluster scatter-gather, and their `n_rows` / `part_rows` extras, come
    with the cluster slice (ROADMAP.md queue 1, slice 6)."""
    if not partials:
        # nothing was dispatched (zero-row table): the empty result still
        # has the pipeline's kind, which comes from the compiled plan
        plan = compile_pipeline(schema, tuple(pipeline))
        if plan.kind == "groups":
            return PipelineResult(kind="groups", groups={})
        raise NotImplementedError(_CLUSTER_SLICE)
    if partials[0].kind != "groups":
        raise NotImplementedError(_CLUSTER_SLICE)
    # the bucket tables AND their collision rows concatenate into one
    # segment-reduce pass (merge_groups_device)
    merged = merge_groups_device([p.groups for p in partials],
                                 partials[0].groups.get("drop_key"))
    return PipelineResult(kind="groups", groups=merged,
                          shipped_bytes=sum(p.shipped_bytes or 0
                                            for p in partials),
                          read_bytes=sum(p.read_bytes for p in partials))
