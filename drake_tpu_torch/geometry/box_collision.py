"""Box-box and capsule-box narrow phase: SAT and branch-free contact manifolds.

The PyTorch counterpart of ``drake_tpu/geometry/box_collision.py``, over the
lanes in the leading dimensions of the poses:

  1. SAT over the 15 candidate axes (3 + 3 face normals, 9 edge crosses)
     picks the axis of maximum separation, with a small bias towards face
     axes.
  2. Face case: the 24 candidate vertices of the clipped polygon (4
     incident corners inside the reference rectangle, 4 rectangle corners
     inside the incident quad, 16 edge crossings) with validity masks; the
     8 deepest valid ones are kept.
  3. Edge case: one contact at the closest points of the two witness edges.

Normals point from box B into box A; inactive slots report phi = +1 m.

Selections take the lowest index among equal values, as ``jnp.argmax`` and
``jax.lax.top_k`` do: ``_first_max`` and ``_first_min`` break ties by index
explicitly, and the 8 deepest candidates come from a stable descending sort.
Aligned boxes and a box lying flat give exact ties.
"""

from __future__ import annotations

import torch

from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.utils.device import constant

_FACE_BIAS = 0.99  # an edge axis must beat the best face axis by > 1% of it
_EPS = 1e-9


def _first_max(x):
    """Index of the first maximum along the last dimension."""
    idx = torch.arange(x.shape[-1], device=x.device)
    hit = x == torch.amax(x, dim=-1, keepdim=True)
    return torch.amin(torch.where(hit, idx, x.shape[-1]), dim=-1)


def _first_min(x):
    return _first_max(-x)


def _take(x, i):
    """x[..., i] for an index tensor i of x's leading shape."""
    return torch.gather(x, -1, i.unsqueeze(-1)).squeeze(-1)


def _take_row(x, i):
    """x[..., i, :] for x (..., n, k) and i (...)."""
    return torch.gather(x, -2, i[..., None, None].expand(i.shape + (1, x.shape[-1]))).squeeze(-2)


def _one_hot(i, dtype):
    return (torch.arange(3, device=i.device) == i[..., None]).to(dtype)


def _mv(R, x):
    return (R @ x.unsqueeze(-1)).squeeze(-1)


def _axes_separations(Ra, ha, Rb, hb, t_W):
    """Separations on the 15 SAT axes: (sep_a (..., 3), sep_b (..., 3), sep_e
    (..., 3, 3), axes_W (..., 3, 3, 3)); sep < 0 means overlap; the edge axes
    cross(Ra_i, Rb_j) oriented from A towards B, parallel pairs at -inf."""
    R = Ra.mT @ Rb  # box-B axes in the A frame
    absR = torch.abs(R) + 1e-6
    t_a = (t_W.unsqueeze(-2) @ Ra).squeeze(-2)  # B's centre in the A frame
    sep_a = torch.abs(t_a) - (ha + _mv(absR, hb))
    t_b = (t_a.unsqueeze(-2) @ R).squeeze(-2)
    sep_b = torch.abs(t_b) - (hb + _mv(absR.mT, ha))
    eye = torch.eye(3, dtype=Ra.dtype, device=Ra.device)
    RT = R.mT  # row j: B's axis j in the A frame
    axes = torch.linalg.cross(eye[:, None, :].expand(R.shape[:-2] + (3, 3, 3)),
                              RT.unsqueeze(-3).expand(R.shape[:-2] + (3, 3, 3)), dim=-1)
    norm = torch.linalg.vector_norm(axes, dim=-1)
    ok = norm > 1e-6
    axes_n = axes / torch.clamp_min(norm, 1e-6)[..., None]
    proj_a = torch.sum(torch.abs(axes_n) * ha, dim=-1)
    proj_b = torch.sum(torch.abs(axes_n @ R.unsqueeze(-3)) * hb, dim=-1)
    dist = torch.sum(axes_n * t_a[..., None, None, :], dim=-1)
    sep_e = torch.abs(dist) - (proj_a + proj_b)
    # Parallel edge pairs are left out of the choice (the face axes cover them).
    sep_e = torch.where(ok, sep_e, torch.full_like(sep_e, -torch.inf))
    axes_n = axes_n * torch.sign(dist)[..., None]
    axes_W = axes_n @ Ra.mT.unsqueeze(-3)
    return sep_a, sep_b, sep_e, axes_W


def _face_manifold(R_ref, p_ref, h_ref, R_inc, p_inc, h_inc, ax):
    """8-slot manifold with the reference face on box 'ref', axis ax (...):
    (phi (..., 8), p_W (..., 8, 3), n_W (..., 8, 3), valid (..., 8)), n_W the
    reference face's outward world normal."""
    dtype = p_ref.dtype
    t = ((p_inc - p_ref).unsqueeze(-2) @ R_ref).squeeze(-2)  # inc centre, ref frame
    t_ax = _take(t, ax)
    s = torch.sign(t_ax) + (t_ax == 0).to(dtype)
    u_i, v_i = (ax + 1) % 3, (ax + 2) % 3
    # Rows (u, v, w) of P map ref-box coordinates to face coordinates.
    P = torch.stack([_one_hot(u_i, dtype), _one_hot(v_i, dtype),
                     s[..., None] * _one_hot(ax, dtype)], dim=-2)
    hu, hv, hw = h_ref[u_i], h_ref[v_i], h_ref[ax]
    M = P @ (R_ref.mT @ R_inc)  # inc axes in the face frame
    t_f = _mv(P, t)

    # Incident face: the inc axis most anti-parallel to +w.
    j = _first_max(torch.abs(M[..., 2, :]))
    m = _take_row(M.mT, j)  # column j of M
    s2 = -torch.sign(m[..., 2]) + (m[..., 2] == 0).to(dtype)
    j1, j2 = (j + 1) % 3, (j + 2) % 3
    e1 = _take_row(M.mT, j1) * h_inc[j1][..., None]
    e2 = _take_row(M.mT, j2) * h_inc[j2][..., None]
    fc = t_f + (s2 * h_inc[j])[..., None] * m

    ring = constant(((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)), p_ref)
    quad = (fc.unsqueeze(-2) + ring[:, 0:1] * e1.unsqueeze(-2)
            + ring[:, 1:2] * e2.unsqueeze(-2))
    quad_uv = quad[..., :2]  # (..., 4, 2)
    m_w = torch.where(torch.abs(m[..., 2]) < 1e-6, torch.ones_like(m[..., 2]), m[..., 2])

    def w_of_uv(uv):  # the incident face's plane over (u, v)
        return fc[..., None, 2] - (m[..., None, 0] * (uv[..., 0] - fc[..., None, 0])
                                   + m[..., None, 1] * (uv[..., 1] - fc[..., None, 1])) / m_w[..., None]

    hu_, hv_ = hu[..., None], hv[..., None]
    # (a) incident corners inside the reference rectangle.
    cand_a_ok = (torch.abs(quad_uv[..., 0]) <= hu_ + _EPS) & (torch.abs(quad_uv[..., 1]) <= hv_ + _EPS)
    # (b) rectangle corners inside the incident quad.
    rect = torch.stack([torch.stack([hu, hv], -1), torch.stack([hu, -hv], -1),
                        torch.stack([-hu, -hv], -1), torch.stack([-hu, hv], -1)], dim=-2)
    edge = torch.roll(quad_uv, -1, dims=-2) - quad_uv
    rel = rect.unsqueeze(-2) - quad_uv.unsqueeze(-3)  # (..., 4 rect, 4 edge, 2)
    cross = edge.unsqueeze(-3)[..., 0] * rel[..., 1] - edge.unsqueeze(-3)[..., 1] * rel[..., 0]
    in_quad = torch.all(cross >= -_EPS, dim=-1) | torch.all(cross <= _EPS, dim=-1)
    d10, d30 = quad_uv[..., 1, :] - quad_uv[..., 0, :], quad_uv[..., 3, :] - quad_uv[..., 0, :]
    area2 = torch.abs(d10[..., 0] * d30[..., 1] - d10[..., 1] * d30[..., 0])
    cand_b_ok = in_quad & (area2 > 1e-8)[..., None]
    # (c) the 16 quad-edge x rectangle-edge crossings; lines n . x = c.
    lines_n = constant(((1.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.0, 1.0)), p_ref)
    lines_c = torch.stack([hu, -hu, hv, -hv], dim=-1)
    den = edge @ lines_n.mT  # (..., 4 edges, 4 lines)
    den = den.mT  # (..., lines, edges)
    num = lines_c[..., :, None] - (quad_uv @ lines_n.mT).mT
    tt = num / torch.where(torch.abs(den) < 1e-9, torch.ones_like(den), den)
    pt = quad_uv.unsqueeze(-3) + tt[..., None] * edge.unsqueeze(-3)  # (..., 4, 4, 2)
    on_seg = (tt >= -_EPS) & (tt <= 1.0 + _EPS) & (torch.abs(den) >= 1e-9)
    # Each crossing must lie within its rectangle edge's span (the other coordinate).
    val = torch.stack([pt[..., 0, :, 1], pt[..., 1, :, 1], pt[..., 2, :, 0], pt[..., 3, :, 0]],
                      dim=-2)
    bound = torch.stack([hv, hv, hu, hu], dim=-1)
    on_span = torch.abs(val) <= bound[..., None] + _EPS
    cand_c_uv = pt.flatten(-3, -2)
    cand_c_ok = (on_seg & on_span).flatten(-2)

    uv = torch.cat([quad_uv, rect, cand_c_uv], dim=-2)  # (..., 24, 2)
    ok = torch.cat([cand_a_ok, cand_b_ok, cand_c_ok], dim=-1)
    phi = w_of_uv(uv) - hw[..., None]

    # The 8 deepest valid candidates, ties in index order (jax.lax.top_k's).
    score = torch.where(ok, -phi, torch.full_like(phi, -torch.inf))
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :8]
    phi8 = torch.gather(phi, -1, idx)
    uv8 = torch.gather(uv, -2, idx[..., None].expand(idx.shape + (2,)))
    ok8 = torch.gather(ok, -1, idx)

    pt_face = torch.cat([uv8, (hw[..., None] + 0.5 * phi8)[..., None]], dim=-1)
    p_G = pt_face @ P
    p_W = p_ref.unsqueeze(-2) + p_G @ R_ref.mT
    n_W = _mv(R_ref, s[..., None] * _one_hot(ax, dtype)).unsqueeze(-2).expand(p_W.shape)
    phi8 = torch.where(ok8, phi8, torch.ones_like(phi8))
    p_W = torch.where(ok8[..., None], p_W, p_ref.unsqueeze(-2))
    return phi8, p_W, n_W, ok8


def _edge_contact(Ra, pa, ha, Rb, pb, hb, axis_W):
    """Closest points of the two witness edges for an SAT edge axis (from A
    towards B): (phi, p_W, n_W from A to B)."""
    dtype = pa.dtype
    ca_ax = (axis_W.unsqueeze(-2) @ Ra).squeeze(-2)  # Ra' axis
    cb_ax = (axis_W.unsqueeze(-2) @ Rb).squeeze(-2)
    sup_a, sup_b = torch.sign(ca_ax), -torch.sign(cb_ax)
    mask_a = _one_hot(_first_min(torch.abs(ca_ax)), dtype)
    mask_b = _one_hot(_first_min(torch.abs(cb_ax)), dtype)
    ca = pa + _mv(Ra, sup_a * ha * (1.0 - mask_a))
    cb = pb + _mv(Rb, sup_b * hb * (1.0 - mask_b))
    da, db = _mv(Ra, mask_a), _mv(Rb, mask_b)
    la, lb = torch.sum(ha * mask_a, dim=-1), torch.sum(hb * mask_b, dim=-1)

    def dot(x, y):
        return torch.sum(x * y, dim=-1)

    r = ca - cb
    ab = dot(da, db)
    det = 1.0 - ab * ab
    sa = (-dot(r, da) + dot(r, db) * ab) / torch.where(det < 1e-9, torch.ones_like(det), det)
    sa = torch.minimum(torch.maximum(sa, -la), la)
    sb = torch.minimum(torch.maximum(dot(r, db) + sa * ab, -lb), lb)
    sa = torch.minimum(torch.maximum(-dot(r, da) + sb * ab, -la), la)
    qa = ca + sa[..., None] * da
    qb = cb + sb[..., None] * db
    d = qb - qa
    dist = torch.linalg.vector_norm(d, dim=-1)
    n = torch.where((dist > 1e-6)[..., None], d / torch.clamp_min(dist, 1e-6)[..., None], axis_W)
    phi = dist * torch.sign(dot(n, axis_W))
    return phi, 0.5 * (qa + qb), n


def box_box_contacts(Ra, pa, size_a, Rb, pb, size_b):
    """The box-box manifold: (phi (..., 8), p_W (..., 8, 3), n_W (..., 8, 3)),
    n_W from B into A; separated boxes report the closest-feature gap in
    slot 0 and phi = +1 in the inactive slots."""
    ha = constant(tuple(float(s) / 2.0 for s in size_a), pa)
    hb = constant(tuple(float(s) / 2.0 for s in size_b), pa)
    sep_a, sep_b, sep_e, axes_e = _axes_separations(Ra, ha, Rb, hb, pb - pa)
    best_face_a, best_face_b = _first_max(sep_a), _first_max(sep_b)
    fa, fb = _take(sep_a, best_face_a), _take(sep_b, best_face_b)
    flat_e = sep_e.flatten(-2)
    best_e = _first_max(flat_e)
    fe = _take(flat_e, best_e)
    axis_e = _take_row(axes_e.flatten(-3, -2), best_e)

    face_sep = torch.maximum(fa, fb)
    use_edge = fe > face_sep + (1.0 - _FACE_BIAS) * torch.abs(face_sep) + 1e-5
    use_a = fa >= fb
    phiA, pA, nA, okA = _face_manifold(Ra, pa, ha, Rb, pb, hb, best_face_a)
    phiB, pB, nB, okB = _face_manifold(Rb, pb, hb, Ra, pa, ha, best_face_b)
    nA = -nA  # face on A: its outward normal points A -> B

    phi_e, p_e, n_e = _edge_contact(Ra, pa, ha, Rb, pb, hb, axis_e)
    slot0 = torch.arange(8, device=pa.device) == 0
    phiE = torch.where(slot0, phi_e[..., None], torch.ones_like(phiA))
    pE = torch.where(slot0[:, None], p_e.unsqueeze(-2), pa.unsqueeze(-2).expand(pA.shape))
    nE = (-n_e).unsqueeze(-2).expand(nA.shape)

    ua = use_a[..., None]
    phiF = torch.where(ua, phiA, phiB)
    pF = torch.where(ua[..., None], pA, pB)
    nF = torch.where(ua[..., None], nA, nB)
    okF = torch.where(ua, okA, okB)
    # No valid face candidate (deep skewed poses): the edge witness instead.
    use_face = (~use_edge) & torch.any(okF, dim=-1)
    uf = use_face[..., None]
    return (torch.where(uf, phiF, phiE), torch.where(uf[..., None], pF, pE),
            torch.where(uf[..., None], nF, nE))


def capsule_box_contacts(Rc, pc, radius, length, Rb, pb, size):
    """Capsule (A) against box (B): 3 contacts, both endpoints and the
    segment's closest point to the box (8 sweeps of alternating
    projection); (phi (..., 3), p_W (..., 3, 3), n_W from the box into the
    capsule)."""
    e1, e2 = sh.capsule_segment_points(Rc, pc, length)
    half = constant(tuple(float(s) / 2.0 for s in size), pc)
    c = 0.5 * (e1 + e2)
    for _ in range(8):
        p_G = ((c - pb).unsqueeze(-2) @ Rb).squeeze(-2)
        q = pb + _mv(Rb, torch.minimum(torch.maximum(p_G, -half), half))
        c = sh.closest_point_on_segment(e1, e2, q)
    pts = torch.stack([e1, e2, c], dim=-2)
    phi_c, n_W = sh.box_sdf_point(Rb, pb, size, pts)
    phi = phi_c - radius
    return phi, pts - n_W * (radius + 0.5 * phi)[..., None], n_W
