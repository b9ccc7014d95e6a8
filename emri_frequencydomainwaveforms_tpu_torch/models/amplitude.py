"""Multipole mode amplitudes A_lmn(p, e).

Counterpart of ``emri_frequencydomainwaveforms_tpu.models.amplitude``
(`ModeTable`, `default_mode_table`, `_orbit_harmonics`, `mode_amplitudes`
with its tail / factorized / rwz rungs, `full_fidelity_amplitudes`). Every
family reduces to

  A_lmn = C_lm * omega_mn^l * F_n[g_lm],   omega_mn = m Omega_phi + n Omega_r,

with F_n the (real) radial-harmonic Fourier coefficient of the orbit
functional g_lm over one radial period of the exact geodesic; see the JAX
module for the derivation. The projection runs in float32 end to end and is
cast to the trajectory's float64 at the end, exactly as in the reference
(parity depends on keeping that rounding point). A float32 matmul on the GPU
runs in full float32 unless ``torch.backends.cuda.matmul.allow_tf32`` is
set, which this module expects to be left at its default (False).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.row_ops import row_sum
from ..utils import tracing
from ..utils.device import resolve_device
from .geodesic import _N_CHI, _antiderivative_matrix
from .rho import _x_of_mode, factorized_correction
from .rwz_calibration import rwz_correction, rwz_ecc_residual
from .tail import tail_factor

# (l, m) -> (azimuthal k of g_lm, r power, ell power, C_re, C_im). A copy of
# the reference table (the port never imports the JAX package); the CPU
# parity tests assert that the two are equal.
_FAMILIES = {
    (2, 2): (2, 2, 0, -2.0 * np.sqrt(np.pi / 5.0), 0.0),
    (2, 0): (0, 2, 0, +np.sqrt(8.0 * np.pi / 15.0), 0.0),
    (2, 1): (1, 1, 1, 0.0, +np.sqrt(64.0 * np.pi / 45.0)),
    (3, 3): (3, 3, 0, 0.0, -np.sqrt(2.0 * np.pi / 189.0)),
    (3, 1): (1, 3, 0, 0.0, +np.sqrt(2.0 * np.pi / 315.0)),
    (3, 2): (2, 2, 1, -np.sqrt(np.pi / 63.0), 0.0),
    (3, 0): (0, 2, 1, +np.sqrt(2.0 * np.pi / 105.0), 0.0),
    (4, 4): (4, 4, 0, +np.sqrt(np.pi / 9072.0), 0.0),
    (4, 2): (2, 4, 0, -np.sqrt(np.pi / 15876.0), 0.0),
    (4, 0): (0, 4, 0, +np.sqrt(np.pi / 17640.0), 0.0),
    # current hexadecapole (l = 4 B-type)
    (4, 3): (3, 3, 1, 0.0, -np.sqrt(2.0 * np.pi / 14175.0)),
    (4, 1): (1, 3, 1, 0.0, +np.sqrt(2.0 * np.pi / 11025.0)),
    # l = 5 mass 2^5-pole  (C = K (-i)^5 = -i K: fit K real -> C imaginary)
    (5, 5): (5, 5, 0, 0.0, +np.sqrt(np.pi / 1188000.0)),
    (5, 3): (3, 5, 0, 0.0, -np.sqrt(np.pi / 2138400.0)),
    (5, 1): (1, 5, 0, 0.0, +np.sqrt(np.pi / 2494800.0)),
    # l = 5 current 2^5-pole  (fit K imaginary -> C real)
    (5, 4): (4, 4, 1, +np.sqrt(np.pi / 1069200.0), 0.0),
    (5, 2): (2, 4, 1, -np.sqrt(np.pi / 801900.0), 0.0),
    (5, 0): (0, 4, 1, +np.sqrt(np.pi / 748440.0), 0.0),
    # l = 6 mass 2^6-pole  (C = K (-i)^6 = -K)
    (6, 6): (6, 6, 0, -np.sqrt(np.pi / 208494000.0), 0.0),
    (6, 4): (4, 6, 0, +np.sqrt(np.pi / 382239000.0), 0.0),
    (6, 2): (2, 6, 0, -np.sqrt(np.pi / 458686800.0), 0.0),
    (6, 0): (0, 6, 0, +8.0764808368e-05, 0.0),
    # l = 6 current 2^6-pole
    (6, 5): (5, 5, 1, 0.0, +np.sqrt(np.pi / 212837625.0)),
    (6, 3): (3, 5, 1, 0.0, -1.41873087857e-04),
    (6, 1): (1, 5, 1, 0.0, +1.49547365463e-04),
    # l = 7 mass 2^7-pole (C = K (-i)^7 = +i K: K real -> C imaginary);
    # round 4, Thorne-4.8 coefficient 4/7! = 1/1260, fit residuals ~9e-11
    # (full-precision numerics: pi/K^2 does not snap cleanly at f64 fit
    # precision; (7,7) is consistent with sqrt(pi/47675628000))
    (7, 7): (7, 7, 0, 0.0, -8.117582762081e-06),
    (7, 5): (5, 7, 0, 0.0, +5.956677244179e-06),
    (7, 3): (3, 7, 0, 0.0, -5.388017293582e-06),
    (7, 1): (1, 7, 0, 0.0, +5.184621961820e-06),
    # l = 7 current 2^7-pole (coefficient 8*7/8! = 1/720; K imaginary ->
    # C = i K real)
    (7, 6): (6, 6, 1, -7.593303376034e-06, 0.0),
    (7, 4): (4, 6, 1, +8.935015866033e-06, 0.0),
    (7, 2): (2, 6, 1, -9.524758893299e-06, 0.0),
    (7, 0): (0, 6, 1, +9.699539140288e-06, 0.0),
    # l = 8 mass 2^8-pole (C = K (-i)^8 = K; coefficient 4/8! = 1/10080)
    (8, 8): (8, 8, 0, +4.765713291088e-07, 0.0),
    (8, 6): (6, 8, 0, -3.480384896283e-07, 0.0),
    (8, 4): (4, 8, 0, +3.127881196656e-07, 0.0),
    (8, 2): (2, 8, 0, -2.982317661474e-07, 0.0),
    (8, 0): (0, 8, 0, +2.940620600128e-07, 0.0),
    # l = 8 current 2^8-pole (coefficient 8*8/9! = 1/5670)
    (8, 7): (7, 7, 1, 0.0, -4.236189592099e-07),
    (8, 5): (5, 7, 1, 0.0, +5.012327120486e-07),
    (8, 3): (3, 7, 1, 0.0, -5.384103027786e-07),
    (8, 1): (1, 7, 1, 0.0, +5.544861311315e-07),
    # l = 9 mass 2^9-pole (round 5; C = K (-i)^9 = -i K: K real ->
    # C imaginary; Thorne coefficient 4/9! = 1/90720, fit residual 9e-10)
    (9, 9): (9, 9, 0, 0.0, +2.512567346957e-08),
    (9, 7): (7, 9, 0, 0.0, -1.828161275733e-08),
    (9, 5): (5, 9, 0, 0.0, +1.635157155513e-08),
    (9, 3): (3, 9, 0, 0.0, -1.549033288529e-08),
    (9, 1): (1, 9, 0, 0.0, +1.513427644922e-08),
    # l = 9 current 2^9-pole (coefficient 8*9/10! = 1/50400; K imaginary
    # -> C = K_im real; fit residual 3e-9)
    (9, 8): (8, 8, 1, +2.131984091075e-08, 0.0),
    (9, 6): (6, 8, 1, -2.533174571240e-08, 0.0),
    (9, 4): (4, 8, 1, +2.736141264720e-08, 0.0),
    (9, 2): (2, 8, 1, -2.839421719954e-08, 0.0),
    (9, 0): (0, 8, 1, +2.872401546235e-08, 0.0),
    # l = 10 mass 2^10-pole (C = K (-i)^10 = -K; coefficient 4/10! =
    # 1/907200, fit residual 5e-9)
    (10, 10): (10, 10, 0, -1.201236950368e-09, 0.0),
    (10, 8): (8, 10, 0, +8.714688780084e-10, 0.0),
    (10, 6): (6, 10, 0, -7.765944547675e-10, 0.0),
    (10, 4): (4, 10, 0, +7.321844397109e-10, 0.0),
    (10, 2): (2, 10, 0, -7.108479184447e-10, 0.0),
    (10, 0): (0, 10, 0, +7.005353442900e-10, 0.0),
    # l = 10 current 2^10-pole (coefficient 8*10/11! = 1/498960; C =
    # -i K_im; fit residual 1.4e-8)
    (10, 9): (9, 9, 1, 0.0, +9.767445375104e-10),
    (10, 7): (7, 9, 1, 0.0, -1.164356770166e-09),
    (10, 5): (5, 9, 1, 0.0, +1.262922175499e-09),
    (10, 3): (3, 9, 1, 0.0, -1.317858933793e-09),
    (10, 1): (1, 9, 1, 0.0, +1.343086309739e-09),
}
_FAMILY_ORDER = list(_FAMILIES)


class ModeTable(NamedTuple):
    """Static (l, m, n) mode inventory (host-side numpy).

    Only m >= 0 modes are tabulated; the summation applies the equatorial
    conjugate symmetry for -m.
    """

    ls: np.ndarray
    ms: np.ndarray
    ns: np.ndarray

    @property
    def num_modes(self) -> int:
        return len(self.ls)

    def take(self, idx) -> "ModeTable":
        """Static sub-table of the given candidate indices."""
        idx = np.asarray(idx)
        return ModeTable(ls=self.ls[idx], ms=self.ms[idx], ns=self.ns[idx])


def default_mode_table(n_max: int = 30, l_max: int = 6) -> ModeTable:
    """Multipole inventory through ``l_max`` (families in ``_FAMILIES``).

    m > 0 families carry n in [-n_max, n_max]; m = 0 families carry
    n in [1, n_max].
    """
    ls, ms, ns = [], [], []
    for (l, m) in _FAMILY_ORDER:
        if l > l_max:
            continue
        n_range = range(1, n_max + 1) if m == 0 else range(-n_max, n_max + 1)
        for n in n_range:
            ls.append(l)
            ms.append(m)
            ns.append(n)
    return ModeTable(np.array(ls), np.array(ms), np.array(ns))


def family_constants(table: ModeTable) -> np.ndarray:
    """(M, 2) float64 constants (C_re, C_im) of each mode's family (0 if none)."""
    c = [_FAMILIES.get((int(l), int(m)), (0, 0, 0, 0.0, 0.0))[3:] for l, m in zip(table.ls, table.ms)]
    return np.asarray(c, dtype=np.float64).reshape(-1, 2)


_PRODUCT_ITEMS = 512  # items in every batched product on the card (_products)


def _products(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for (R, M, K) ``a`` and a (K, N) ``w`` shared by the R
    items or (R, K, N) one per item, each item's result independent of R.

    On the card cuBLAS picks its kernel from the whole shape, the number of
    items included: the (R M, K) @ (K, N) GEMM takes another kernel
    (split-K among them) for another R, and so does the batched product at
    some item shapes (a card test found (1, 256) @ (256, 9) items differ
    between 192 and 512 of them). So every call here is a batched product
    of exactly _PRODUCT_ITEMS items: R is cut into such chunks, the last
    padded with zeros, and each item's arithmetic depends on its shape
    alone. On the CPU ``torch.matmul`` already keeps each item's order, and
    its GEMM matches the JAX package's float32 product more closely than a
    batched one.
    """
    if a.device.type == "cpu":
        return torch.matmul(a, w)
    r, c = a.shape[0], _PRODUCT_ITEMS
    outs = []
    for i in range(0, r, c):
        ai = a[i:i + c]
        wi = w if w.dim() == 2 else w[i:i + c]
        n = ai.shape[0]
        if n < c:
            ai = torch.cat([ai, ai.new_zeros((c - n,) + ai.shape[1:])])
            if wi.dim() == 3:
                wi = torch.cat([wi, wi.new_zeros((c - n,) + wi.shape[1:])])
        if wi.dim() == 2:
            wi = wi.expand(c, *wi.shape)
        outs.append(torch.bmm(ai, wi)[:n])
    return torch.cat(outs) if outs else a.new_zeros(a.shape[:-1] + w.shape[-1:])


def _orbit_harmonics(p, e, n_max: int, fam_subset: tuple[int, ...] | None = None):
    """Fourier coefficients F_n[g_lm] of the requested multipole families.

    ``p``, ``e``: float tensors of any shape (flattened to a (BK,) batch).
    Returns ``f_fam`` float32 of shape ``p.shape + (len(subset), 2 n_max + 1)``
    indexed by (subset order, n = -n_max..n_max), plus (omega_phi, omega_r)
    float32 of shape ``p.shape``.
    """
    if fam_subset is None:
        fam_subset = tuple(range(len(_FAMILY_ORDER)))
    shape = p.shape
    dev = p.device
    f32 = torch.float32
    n_chi = _N_CHI
    p32 = p.reshape(-1).to(f32)[:, None]  # (BK, 1)
    e32 = e.reshape(-1).to(f32)[:, None]

    chi = (2.0 * np.pi / n_chi) * np.arange(n_chi)
    cos_chi = torch.as_tensor(np.cos(chi), dtype=f32, device=dev)[None, :]

    ecos = e32 * cos_chi
    rad = p32 - 6.0 - 2.0 * ecos
    r = p32 / (1.0 + ecos)
    dphi_dchi = torch.sqrt(p32 / rad)
    dt_dchi = (
        p32 * p32 * torch.sqrt((p32 - 2.0) ** 2 - 4.0 * e32 * e32)
        / ((p32 - 2.0 - 2.0 * ecos) * (1.0 + ecos) ** 2 * torch.sqrt(rad))
    )
    h = float(np.float32(2.0 * np.pi / n_chi))
    # every reduction and product over the chi nodes in an order fixed per
    # row, so that a walker's amplitudes do not depend on its batch
    # (ops/row_ops.py, _products)
    t_r = row_sum(dt_dchi)[:, None] * h  # (BK, 1)
    dphi_tot = row_sum(dphi_dchi)[:, None] * h
    omega_r = 2.0 * np.pi / t_r
    omega_phi = dphi_tot / t_r

    # periodic antiderivatives, kept split as (periodic part, mean)
    a_op_t = torch.as_tensor(_antiderivative_matrix(n_chi).T, dtype=f32, device=dev)

    def periodic_antiderivative(g):
        mean = row_sum(g, mean=True)[:, None]
        return _products((g - mean)[:, None, :], a_op_t)[:, 0], mean

    t_per, t_mean = periodic_antiderivative(dt_dchi)
    phi_per, phi_mean = periodic_antiderivative(dphi_dchi)

    # periodic azimuth dphi = phi - omega_phi t, from the small parts only
    dphi = phi_per - omega_phi * t_per
    w = dt_dchi * (h / t_r)  # sums to 1

    ell = (r * r) * dphi_dchi / dt_dchi
    k_top = max(_FAMILIES[_FAMILY_ORDER[i]][0] for i in fam_subset)
    rp_top = max(_FAMILIES[_FAMILY_ORDER[i]][1] for i in fam_subset)
    c1, s1 = torch.cos(dphi), torch.sin(dphi)
    ck = {0: (torch.ones_like(c1), torch.zeros_like(s1)), 1: (c1, s1)}
    for k in range(2, max(k_top, 1) + 1):
        cprev, sprev = ck[k - 1]
        ck[k] = (cprev * c1 - sprev * s1, sprev * c1 + cprev * s1)
    rpow = {1: r}
    for rp in range(2, max(rp_top, 1) + 1):
        rpow[rp] = rpow[rp - 1] * r

    def fval(rp, lp):
        base = rpow[rp]
        return ell * base if lp else base

    # harmonic basis e^{-i n theta}, theta = chi + theta_per, split exactly:
    # n chi_j mod 2pi on the host, theta_per as a 2^-13-quantized head (n x
    # head exact in float32) plus a small tail (see the JAX module)
    theta_per = t_per / t_mean  # (BK, n_chi)
    th_hi = torch.round(theta_per * 8192.0) * float(np.float32(1.0 / 8192.0))
    th_lo = theta_per - th_hi
    n_np = np.arange(n_max + 1)
    ang_grid = 2.0 * np.pi * ((n_np[None, :] * np.arange(n_chi)[:, None]) % n_chi) / n_chi
    cos_a = torch.as_tensor(np.cos(ang_grid), dtype=f32, device=dev)[None]
    sin_a = torch.as_tensor(np.sin(ang_grid), dtype=f32, device=dev)[None]
    n_arr = torch.as_tensor(n_np, dtype=f32, device=dev)
    two_pi_hi = 6.28125  # exact in 8 bits: 2pi = hi + lo
    two_pi_lo = float(np.float32(2.0 * np.pi - 6.28125))
    ang_hi = th_hi[:, :, None] * n_arr[None, None, :]
    k = torch.round(ang_hi * float(np.float32(1.0 / (2.0 * np.pi))))
    b_small = (ang_hi - k * two_pi_hi) - k * two_pi_lo + th_lo[:, :, None] * n_arr
    cos_b = torch.cos(b_small)
    sin_b = torch.sin(b_small)
    cs = torch.cat([cos_a * cos_b - sin_a * sin_b, sin_a * cos_b + cos_a * sin_b], dim=-1)

    # one integrand row per family cos part (DC subtracted, restored after)
    # and, for k > 0, one sin part; the coefficients are real by chi-parity
    rows = []
    row_meta = []  # (subset position, 0 cos / 1 sin)
    means = []
    for si, fi in enumerate(fam_subset):
        k, rp, lp, _, _ = _FAMILIES[_FAMILY_ORDER[fi]]
        f_vals = fval(rp, lp)
        ckk, skk = ck[k]
        fc = f_vals * ckk
        mc = row_sum(w * fc)[:, None]
        rows.append(w * (fc - mc))
        row_meta.append((si, 0))
        means.append(mc)
        if k > 0:
            rows.append(w * (f_vals * skk))
            row_meta.append((si, 1))
    integ = torch.stack(rows, dim=1)  # (BK, n_rows, n_chi)
    proj = _products(integ, cs)  # (BK, n_rows, 2(n_max+1))

    np1 = n_max + 1
    dc = torch.zeros((1, np1), dtype=f32, device=dev)
    dc[0, 0] = 1.0
    n_fam = len(fam_subset)
    cos_part = [None] * n_fam
    sin_part = [torch.zeros_like(proj[:, 0, np1:])] * n_fam
    mi = 0
    for ri, (si, which) in enumerate(row_meta):
        if which == 0:
            cos_part[si] = proj[:, ri, :np1] + means[mi] * dc
            mi += 1
        else:
            sin_part[si] = proj[:, ri, np1:]
    f_all = []
    for fi in range(n_fam):
        wc, ws = cos_part[fi], sin_part[fi]
        # n = -n_max..-1 (reversed wc - ws tail), then 0..n_max (wc + ws)
        f_all.append(torch.cat([torch.flip((wc - ws)[:, 1:], dims=(-1,)), wc + ws], dim=-1))
    f_fam = torch.stack(f_all, dim=1)  # (BK, n_fam, 2 n_max + 1)
    return (
        f_fam.reshape(shape + f_fam.shape[1:]),
        omega_phi[:, 0].reshape(shape),
        omega_r[:, 0].reshape(shape),
    )


@tracing.spanned("amplitudes")
def mode_amplitudes(
    p: torch.Tensor, e: torch.Tensor, table: ModeTable,
    *, tail: bool = False, tail_r0: float = 2.0,
    factorized: bool = False, rwz: bool = False,
    family_c: torch.Tensor | None = None,
    rwz_rows: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A_lmn(p, e) for every mode in ``table`` -> (re, im) of ``p.shape + (M,)``.

    ``tail=True`` multiplies each harmonic by the relativistic tail factor
    T_lm(omega_mn) (`models.tail`, gauge constant ``tail_r0``);
    ``factorized=True`` by the effective source and residual resummation
    S_hat rho_lm^l e^{i delta_lm} (`models.rho`); ``rwz=True`` (only on top
    of the other two) by the strong-field calibration B_lm(x_mn) R_lmn(u, e)
    (`models.rwz_calibration`).

    ``family_c`` and ``rwz_rows``: the table's (M, 2) family constants
    (`family_constants`) and its calibration rows
    (`rwz_calibration.rwz_rows`) already on the device, as a batch-frozen
    module keeps them; None looks them up.
    """
    if rwz and not (tail and factorized):
        raise ValueError("rwz=True requires tail=True, factorized=True")
    n_max = int(np.max(np.abs(table.ns))) if table.num_modes else 0
    dev = p.device

    fam_lookup = {lm: i for i, lm in enumerate(_FAMILY_ORDER)}
    fam_idx = np.array(
        [fam_lookup.get((int(l), int(m)), -1) for l, m in zip(table.ls, table.ms)]
    )
    known = fam_idx >= 0
    fam_idx_safe = np.where(known, fam_idx, 0)
    fam_subset = tuple(sorted(set(fam_idx_safe.tolist())))
    sub_pos = {fi: si for si, fi in enumerate(fam_subset)}
    fam_pos = np.array([sub_pos[fi] for fi in fam_idx_safe])

    f_fam, omega_phi, omega_r = _orbit_harmonics(p, e, n_max, fam_subset)

    n_idx = table.ns + n_max
    if family_c is None:
        family_c = torch.as_tensor(family_constants(table), dtype=torch.float64, device=dev)
    c32 = family_c.to(torch.float32)

    f_sel = f_fam[..., torch.as_tensor(fam_pos, device=dev), torch.as_tensor(n_idx, device=dev)]

    m_f = torch.as_tensor(table.ms.astype(np.float32), device=dev)
    n_f = torch.as_tensor(table.ns.astype(np.float32), device=dev)
    omega_mn = m_f * omega_phi[..., None] + n_f * omega_r[..., None]
    # omega^l with possibly negative omega (the same product chain as the
    # reference, so the float32 rounding matches)
    w2 = omega_mn * omega_mn
    w3 = w2 * omega_mn
    w4 = w2 * w2
    w8 = w4 * w4
    powers = {2: w2, 3: w3, 4: w4, 5: w4 * omega_mn, 6: w4 * w2, 7: w4 * w3, 8: w8,
              9: w8 * omega_mn}
    pw = w8 * w2
    ls = torch.as_tensor(table.ls, device=dev)
    for l in (9, 8, 7, 6, 5, 4, 3, 2):
        pw = torch.where(ls == l, powers[l], pw)

    a = pw * f_sel
    # downstream (spline fits, FD pass) runs float64; values carry float32
    # accuracy (~1e-6 relative)
    dt = p.dtype
    re = (c32[:, 0] * a).to(dt)
    im = (c32[:, 1] * a).to(dt)
    if not (tail or factorized):
        return re, im
    # the corrections take the float32 mode frequency, cast: the value the
    # flat amplitude was formed with, not a float64 recomputation
    omega = omega_mn.to(dt)
    if tail:
        t_re, t_im = tail_factor(table.ls, omega, r0=tail_r0)
        re, im = re * t_re - im * t_im, re * t_im + im * t_re
    if factorized:
        c_re, c_im = factorized_correction(table.ls, table.ms, p, e, omega)
        re, im = re * c_re - im * c_im, re * c_im + im * c_re
    if rwz:
        from .amplitude_backends import u_of_pe  # amplitude_backends imports this module

        b_rows, r_rows = rwz_rows if rwz_rows is not None else (None, None)
        b = rwz_correction(table.ls, table.ms, _x_of_mode(omega, table.ms), rows=b_rows)
        # complex eccentric residual: |R| corrects the modulus, arg R the
        # per-mode phase
        r_re, r_im = rwz_ecc_residual(
            table.ls, table.ms, table.ns, u_of_pe(p, e), e, rows=r_rows
        )
        c_re, c_im = b * r_re, b * r_im
        re, im = re * c_re - im * c_im, re * c_im + im * c_re
    return re, im


def full_fidelity_amplitudes(
    p: torch.Tensor, e: torch.Tensor, table: ModeTable
) -> tuple[torch.Tensor, torch.Tensor]:
    """`mode_amplitudes` at the highest physics rung: tail + factorized
    resummation + the rwz strong-field calibration with its eccentric
    residual."""
    return mode_amplitudes(p, e, table, tail=True, factorized=True, rwz=True)


class NewtonianAmplitude:
    """The reference's amplitude-module call signature.

    ``amp(p, e, specific_modes=[(l, m, n), ...])`` returns ``{(l, m, n):
    complex numpy array}`` (every mode of `default_mode_table(n_max)` when
    no modes are named). Negative-m requests come from the equatorial
    symmetry A_{l,-m,-n} = (-1)^l conj(A_{l,m,n}). ``device``: where the
    amplitudes are computed (default the tensor argument's, else the
    current CUDA device).
    """

    def __init__(self, device=None, **kwargs):
        del kwargs  # the reference's max_init_len / use_gpu
        self.device = device

    def __call__(self, p, e, specific_modes=None, n_max: int = 30):
        dev = resolve_device(self.device, p, e)
        p = torch.as_tensor(p, dtype=torch.float64, device=dev)
        e = torch.as_tensor(e, dtype=torch.float64, device=dev)
        if specific_modes is None:
            table = default_mode_table(n_max)
            re, im = (x.cpu().numpy() for x in mode_amplitudes(p, e, table))
            return {
                (int(l), int(m), int(n)): re[..., i] + 1j * im[..., i]
                for i, (l, m, n) in enumerate(zip(table.ls, table.ms, table.ns))
            }
        # served from the m >= 0 half: (l, -m, -n) for m < 0, with a flip
        req = [(l, -m, -n) if m < 0 else (l, m, n) for l, m, n in specific_modes]
        table = ModeTable(*(np.array(col) for col in zip(*req)))
        re, im = (x.cpu().numpy() for x in mode_amplitudes(p, e, table))
        out = {}
        for i, (l, m, n) in enumerate(specific_modes):
            a = re[..., i] + 1j * im[..., i]
            out[(l, m, n)] = (-1.0) ** l * np.conj(a) if m < 0 else a
        return out


__all__ = [
    "ModeTable",
    "default_mode_table",
    "family_constants",
    "mode_amplitudes",
    "full_fidelity_amplitudes",
    "NewtonianAmplitude",
]
