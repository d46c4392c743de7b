"""LBVH traversal — counterpart of vkrt_tpu/rt/traverse.py (the reference
backend's trace; plain PyTorch, not a hand-written kernel).

Short-stack depth-first traversal over accel/lbvh.py's BVH2, all rays in
lock-step, state struct-of-arrays over rays ([B] nodes, [B,64] stacks,
[B] best hits). Per iteration and ray: fetch one internal node (both
children's boxes and links), intersect leaf children inline, follow the
nearer internal child that the slab test passes and push the farther.

The JAX package loops in `lax.while_loop` until every ray has finished;
here the loop runs on the host and asks the card once per iteration
whether any ray is still active (one host wait per iteration: slow,
correct, and enough for a reference backend).

trace_closest returns (t, tri, u, v) with tri in the original triangle
numbering (-1 and t = tmax on a miss); trace_occluded any-hit bool[B].
"""

from __future__ import annotations

import torch

from vkrt_tpu_torch.accel.lbvh import BVH2
from vkrt_tpu_torch.rt.intersect import (moller_trumbore, safe_inv_dir,
                                         slab_test)

# Worst-case LBVH depth: 30 Morton levels plus log2 of the longest run of
# duplicate codes. A push past the top is dropped (the deepest far child
# is lost, a conservative miss) and keeps push and pop consistent; at 64
# it cannot happen.
STACK_DEPTH = 64


def _traverse_block(bvh: BVH2, origins, dirs, tmin: float, tmax,
                    occlusion: bool):
    """origins, dirs f32[B,3], tmax f32[B]. Returns (t, slot, u, v)."""
    B = origins.shape[0]
    dev = origins.device
    inv_d = safe_inv_dir(dirs)
    node = torch.zeros(B, dtype=torch.long, device=dev)
    stack = torch.zeros((B, STACK_DEPTH), dtype=torch.long, device=dev)
    sp = torch.zeros(B, dtype=torch.long, device=dev)
    t_best = tmax.clone()
    slot_best = torch.full((B,), -1, dtype=torch.long, device=dev)
    u_best = torch.zeros(B, device=dev)
    v_best = torch.zeros(B, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)

    def intersect(slot, active):
        nonlocal t_best, slot_best, u_best, v_best
        sv = torch.clamp(slot, min=0)
        t, u, v, ok = moller_trumbore(origins, dirs, bvh.tri_v0[sv],
                                      bvh.tri_e1[sv], bvh.tri_e2[sv], tmin,
                                      t_best)
        ok = ok & active
        t_best = torch.where(ok, t, t_best)
        slot_best = torch.where(ok, slot, slot_best)
        u_best = torch.where(ok, u, u_best)
        v_best = torch.where(ok, v, v_best)

    while not bool(finished.all()):
        box = bvh.boxes[node]                       # [B,12]
        kid = bvh.kids[node].long()                 # [B,2]
        limit = torch.minimum(tmax, t_best)
        tl, _, hit_l = slab_test(box[:, 0:3], box[:, 3:6], origins, inv_d,
                                 tmin, limit)
        tr, _, hit_r = slab_test(box[:, 6:9], box[:, 9:12], origins, inv_d,
                                 tmin, limit)
        hit_l = hit_l & ~finished
        hit_r = hit_r & ~finished
        leaf_l = kid[:, 0] < 0
        leaf_r = kid[:, 1] < 0

        intersect(-kid[:, 0] - 1, hit_l & leaf_l)
        intersect(-kid[:, 1] - 1, hit_r & leaf_r)
        if occlusion:
            finished = finished | (slot_best >= 0)

        go_l = hit_l & ~leaf_l
        go_r = hit_r & ~leaf_r
        both = go_l & go_r
        near_is_l = tl <= tr
        near = torch.where(near_is_l, kid[:, 0], kid[:, 1])
        far = torch.where(near_is_l, kid[:, 1], kid[:, 0])
        one = torch.where(go_l, kid[:, 0], kid[:, 1])

        # push the far child where both internal children hit; a full
        # stack drops the push and does not advance sp
        push_ok = both & ~finished & (sp < STACK_DEPTH)
        top = torch.clamp(sp, max=STACK_DEPTH - 1)[:, None]
        kept = stack.gather(1, top)[:, 0]
        stack.scatter_(1, top, torch.where(push_ok, far, kept)[:, None])
        sp = sp + push_ok.long()

        need_pop = ~(go_l | go_r) | finished
        popped_sp = torch.clamp(sp - 1, min=0)
        popped = stack.gather(1, popped_sp[:, None])[:, 0]
        finished = finished | (need_pop & (sp == 0))
        node = torch.where(finished, 0,
                           torch.where(need_pop, popped,
                                       torch.where(both, near, one)))
        sp = torch.where(need_pop & ~finished, popped_sp, sp)
    return t_best, slot_best, u_best, v_best


def _tmax_rows(tmax, origins):
    return torch.as_tensor(tmax, dtype=torch.float32,
                           device=origins.device).expand(
                               origins.shape[0]).contiguous()


def trace_closest(bvh: BVH2, origins, dirs, tmin: float, tmax):
    """Closest hit of rays f32[B,3] within (tmin, tmax); tmax a float or
    f32[B]. Returns (t, tri i32, u, v); tri = -1 on a miss."""
    t, slot, u, v = _traverse_block(bvh, origins, dirs, tmin,
                                    _tmax_rows(tmax, origins), False)
    tri = torch.where(slot >= 0, bvh.leaf_tri[torch.clamp(slot, min=0)], -1)
    return t, tri.to(torch.int32), u, v


def trace_occluded(bvh: BVH2, origins, dirs, tmin: float, tmax):
    """Any hit within (tmin, tmax): bool[B], True where blocked."""
    _, slot, _, _ = _traverse_block(bvh, origins, dirs, tmin,
                                    _tmax_rows(tmax, origins), True)
    return slot >= 0
