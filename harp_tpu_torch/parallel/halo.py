"""Halo exchange for temporal (neighbour-frame) losses on a frame axis
split over ranks (harp_tpu/parallel/halo.py).

The reference's temporal-smoothness losses index frames fid +- 1
(loss/smooth.py:38-40). With the frame axis split over ranks, the
neighbours of a rank's first and last rows live on the neighbouring ranks:
one boundary row goes each way, point to point.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from harp_tpu_torch.parallel.sharding import FRAME_AXIS, Mesh


def neighbor_shift(mesh: Mesh, x: torch.Tensor):
    """For this rank's rows x (N / world, ...) of a frame-split (N, ...)
    array, return (left, right): left[i] = x[i - 1], right[i] = x[i + 1] in
    the global frame order, clamped at the sequence's ends (frame 0 is its
    own left neighbour, frame N - 1 its own right), the reference's
    boundary convention.

    Gloo does not send CUDA tensors: on a gloo mesh the two boundary rows
    travel through the host."""
    w, r = mesh.axis_size(FRAME_AXIS), mesh.axis_index(FRAME_AXIS)
    from_left, from_right = x[:1], x[-1:]  # the clamp at the sequence's ends
    if w > 1:
        line, group = mesh.lines[FRAME_AXIS], mesh.groups[FRAME_AXIS]
        staged = mesh.backend == "gloo" and x.is_cuda
        wire = x.cpu() if staged else x
        ops, recv = [], {}
        if r > 0:  # my first row to the left neighbour, its last row to me
            recv["left"] = torch.empty_like(wire[:1])
            ops += [dist.P2POp(dist.isend, wire[:1].contiguous(), line[r - 1], group),
                    dist.P2POp(dist.irecv, recv["left"], line[r - 1], group)]
        if r < w - 1:
            recv["right"] = torch.empty_like(wire[:1])
            ops += [dist.P2POp(dist.isend, wire[-1:].contiguous(), line[r + 1], group),
                    dist.P2POp(dist.irecv, recv["right"], line[r + 1], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if "left" in recv:
            from_left = recv["left"].to(x.device)
        if "right" in recv:
            from_right = recv["right"].to(x.device)
    left = torch.cat([from_left, x[:-1]], 0)
    right = torch.cat([x[1:], from_right], 0)
    return left, right
