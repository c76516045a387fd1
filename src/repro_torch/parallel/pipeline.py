"""Pipeline parallelism over a mesh axis (GPipe schedule, point-to-point
hops) — the reference's ``repro.parallel.pipeline`` in PyTorch.

For models whose optimizer state cannot fit one pod, the ``pod`` axis can
carry pipeline stages instead of pure DP: each pod holds a contiguous
layer range; microbatches stream through with point-to-point hops (the
DCN-friendly pattern — no all-reduce crosses pods).

``pipeline_apply`` is schedule-only and model-agnostic: it runs a stage
function with the classic (m + n_stages - 1)-tick GPipe loop, bubbles
included (every stage computes every tick; an inactive stage's result is
dropped).  Each tick's hop is an ``isend`` to stage i + 1 and an ``irecv``
from stage i - 1 over the axis's process group (the ring's wrap reaches
stage 0, which ignores it).  At the end the last stage sends its outputs
to every other stage, so every stage returns the same value.  The
reference means the same final step, but its ``ppermute`` with one source
and n destinations is refused by jax for n > 1 (ROADMAP divergence 17).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _exchange(y, group, idx: int, n: int):
    """``y`` sent to stage ``idx + 1``, and what stage ``idx - 1`` sent
    received (mod n)."""
    if n == 1:
        return y
    y = y.contiguous()
    buf = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, dist.get_global_rank(group, (idx + 1) % n),
                      group),
           dist.P2POp(dist.irecv, buf,
                      dist.get_global_rank(group, (idx - 1) % n), group)]
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    return buf


def pipeline_apply(stage_fn, stage_params, x_mb, mesh, axis: str = "pod"):
    """Run microbatches through pipeline stages laid out along ``axis``.

    stage_fn(params_i, x) -> y           (one stage's compute)
    stage_params: tree whose leaves have a leading dim of n_stages (every
        stage's, this rank takes its own) or of 1 (this stage's alone)
    x_mb: [m, ...] microbatches (the same on every stage)
    Returns stacked outputs [m, ...] (from the last stage, on every stage).
    """
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    m = x_mb.shape[0]
    params = _tree_map(lambda a: a[idx] if a.shape[0] == n else a[0],
                       stage_params)
    buf = torch.zeros_like(x_mb[0])          # inbound activation
    outs = torch.zeros_like(x_mb)
    for t in range(m + n - 1):
        # stage 0 ingests microbatch t (when valid)
        x_in = x_mb[min(max(t, 0), m - 1)] if idx == 0 else buf
        active = 0 <= t - idx < m
        y = stage_fn(params, x_in)
        if not active:
            y = buf
        # the last stage emits at slot (t - n + 1)
        if active and idx == n - 1:
            outs[min(max(t - n + 1, 0), m - 1)] = y
        buf = _exchange(y, group, idx, n)
    # every stage takes the last stage's outputs
    if n > 1:
        last = dist.get_global_rank(group, n - 1)
        if idx == n - 1:
            reqs = [dist.isend(outs, dist.get_global_rank(group, i), group)
                    for i in range(n - 1)]
        else:
            reqs = [dist.irecv(outs, last, group)]
        for r in reqs:
            r.wait()
    return outs
