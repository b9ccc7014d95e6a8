"""Derive the multipole projection constants K_lm on the PyTorch port
(l <= 8 by default).

The port's counterpart of ``tools/derive_multipoles.py``. Method: Thorne
1980 eq. (4.8) gives the radiative field as contractions of
time-derivatives of the source's mass/current multipole moments with the
line-of-sight N (G = c = 1, prefactor 1/D). Contracting with the null
polarization vector w = e_Theta - i e_Phi (h = h_+ - i h_x = w^j w^k h_jk)
kills every delta term.

Every tensor component of the moments is represented EXACTLY as a torus
Fourier series: a dict {m_azimuthal: periodic array over the Darwin angle}
whose products convolve over m, and whose (m, n) harmonic coefficients
u_mn multiply by (i omega_mn)^L under d^L/dt^L. The assembled h(t) is
therefore spectrally exact, and the posited mode structure

  A_lmn = K_lm * (-i omega_mn)^l * F_n[g_lm],

with F_n the production Fourier convention and g_lm the orbit functional,
is fit for the single complex constant K_lm per family by exact linear
projection. The orbit is the port's `geodesic.darwin_orbit` and the
harmonics' angular factors the port's `spin_weighted_ylm`, both in float64
on the chosen torch device; the torus algebra is float64 numpy on the host,
a copy of the original's. The recovered constants are checked against the
ones hard-coded in the port's ``models/amplitude.py`` (``_FAMILIES``:
C_lm = K_lm (-i)^l).

Run on the current CUDA device, or on the CPU with ``--device cpu``:

    PYTHONPATH=. python tools/torch_derive_multipoles.py [--device cpu]

(``L_TOP`` / ``L_ONLY`` in the environment as for the original.)
"""

import argparse

import numpy as np

import os as _os

N_CHI = 2048
N_MAX = 40
# L_TOP (env): the highest multipole degree to derive (the STF/torus
# machinery is rank-generic; up to l = 10). L_ONLY (env) restricts the
# fit/printout to l >= L_ONLY terms.
L_TOP = int(_os.environ.get("L_TOP", "8"))
L_ONLY = int(_os.environ.get("L_ONLY", "0"))


def orbit_data(p, e, device=None):
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.models.geodesic import darwin_orbit
    from emri_frequencydomainwaveforms_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    orb = darwin_orbit(torch.tensor(float(p), dtype=torch.float64, device=dev),
                       torch.tensor(float(e), dtype=torch.float64, device=dev), n_chi=N_CHI)
    orb = {k: v.cpu().numpy() for k, v in orb.items()}
    chi = np.asarray(orb["chi"])
    r = np.asarray(orb["r"])
    t = np.asarray(orb["t"])
    phi = np.asarray(orb["phi"])
    t_r = float(orb["T_r"])
    dphi = float(orb["Dphi"])
    om_r = 2 * np.pi / t_r
    om_phi = dphi / t_r
    dphi_per = phi - om_phi * t  # periodic azimuth
    # quadrature weights: (dt/dchi) dchi / T_r (sums to 1)
    ecos = e * np.cos(chi)
    rad = p - 6.0 - 2.0 * ecos
    dt_dchi = (
        p * p * np.sqrt((p - 2.0) ** 2 - 4.0 * e * e)
        / ((p - 2.0 - 2.0 * ecos) * (1.0 + ecos) ** 2 * np.sqrt(rad))
    )
    w = dt_dchi * (2 * np.pi / N_CHI) / t_r
    ell = r**2 * np.sqrt(p / rad) / dt_dchi * (2 * np.pi / N_CHI) / (2 * np.pi / N_CHI)
    # l = r^2 dphi/dt = r^2 (dphi/dchi)/(dt/dchi)
    ell = r**2 * np.sqrt(p / rad) / dt_dchi
    theta_r = om_r * t  # radial angle
    return dict(r=r, dphi=dphi_per, w=w, th=theta_r, om_r=om_r, om_phi=om_phi, ell=ell,
                device=dev)


class Torus:
    """Scalar functional on the orbital torus: {m: periodic array(chi)}."""

    def __init__(self, comps):
        self.c = dict(comps)

    def __mul__(self, other):
        if isinstance(other, Torus):
            out = {}
            for m1, a in self.c.items():
                for m2, b in other.c.items():
                    out[m1 + m2] = out.get(m1 + m2, 0) + a * b
            return Torus(out)
        return Torus({m: a * other for m, a in self.c.items()})

    __rmul__ = __mul__

    def __add__(self, other):
        out = dict(self.c)
        for m, a in other.c.items():
            out[m] = out.get(m, 0) + a
        return Torus(out)

    def __sub__(self, other):
        return self + (-1.0) * other

    def coeffs(self, od):
        """(m, n) harmonic table: C(t) = sum u[m][n] e^{i(m om_phi + n om_r) t}."""
        basis = np.exp(-1j * np.arange(-N_MAX, N_MAX + 1)[:, None] * od["th"][None, :])
        return {
            m: (basis * (od["w"] * g)[None, :]).sum(axis=1) for m, g in self.c.items()
        }


def h_of_t(coeff_tables, od, t_grid, deriv_orders):
    """Sum_{m,n} (i om_mn)^L u_mn e^{i om_mn t} for each (table, L) pair."""
    ns = np.arange(-N_MAX, N_MAX + 1)
    out = np.zeros(len(t_grid), dtype=complex)
    for tab, L in zip(coeff_tables, deriv_orders):
        for m, u in tab.items():
            om = m * od["om_phi"] + ns * od["om_r"]
            fac = (1j * om) ** L * u
            out += (fac[None, :] * np.exp(1j * om[None, :] * t_grid[:, None])).sum(axis=1)
    return out


def brute_force_terms(p, e, theta, phi_v, t_grid, l_top=None, l_only=None, device=None):
    """Each Thorne-4.8 term's h(t) = (1/2) w^j w^k [term]_jk, spectrally exact.

    Full STF moments (the trace corrections with both free indices on N
    survive the null contraction for l=4, so raw moments are NOT enough).
    The 1/2 casts w^j w^k h_jk = h_TT,ThTh - h_PhPh - 2i h_ThPh onto
    h_+ - i h_x.
    """
    l_top = L_TOP if l_top is None else l_top
    l_only = L_ONLY if l_only is None else l_only
    od = orbit_data(p, e, device)
    r = od["r"]
    dphi = od["dphi"]
    ell = od["ell"]
    E = np.exp(1j * dphi)

    zero = Torus({})
    xv = {
        "x": Torus({+1: 0.5 * r * E, -1: 0.5 * r * np.conj(E)}),
        "y": Torus({+1: -0.5j * r * E, -1: +0.5j * r * np.conj(E)}),
        "z": zero,
    }
    Lv = {"x": zero, "y": zero, "z": Torus({0: ell})}
    rsq = Torus({0: r * r})
    AX = "xyz"

    def delta(a, b):
        return 1.0 if a == b else 0.0

    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi_v), np.sin(phi_v)
    w = {"x": ct * cp + 1j * sp, "y": ct * sp - 1j * cp, "z": -st}
    N = {"x": st * cp, "y": st * sp, "z": ct}
    eps = {}
    for i, a in enumerate(AX):
        for j, b in enumerate(AX):
            for k, c in enumerate(AX):
                eps[a + b + c] = ((i - j) * (j - k) * (k - i)) / 2.0

    # ---- STF moments as Torus dicts ----
    M2 = {(j, k): xv[j] * xv[k] - (delta(j, k) / 3.0) * rsq for j in AX for k in AX}
    M3 = {}
    for j in AX:
        for k in AX:
            for l in AX:
                M3[(j, k, l)] = xv[j] * xv[k] * xv[l] - (1.0 / 5.0) * (
                    delta(j, k) * (rsq * xv[l])
                    + delta(j, l) * (rsq * xv[k])
                    + delta(k, l) * (rsq * xv[j])
                )
    S2 = {
        (k, pp): 0.5 * (Lv[k] * xv[pp]) + 0.5 * (Lv[pp] * xv[k])
        for k in AX
        for pp in AX
    }
    M4 = {}
    for j in AX:
        for k in AX:
            for l in AX:
                for mm in AX:
                    raw = xv[j] * xv[k] * xv[l] * xv[mm]
                    tr1 = (1.0 / 7.0) * (
                        delta(j, k) * (rsq * (xv[l] * xv[mm]))
                        + delta(j, l) * (rsq * (xv[k] * xv[mm]))
                        + delta(j, mm) * (rsq * (xv[k] * xv[l]))
                        + delta(k, l) * (rsq * (xv[j] * xv[mm]))
                        + delta(k, mm) * (rsq * (xv[j] * xv[l]))
                        + delta(l, mm) * (rsq * (xv[j] * xv[k]))
                    )
                    tr2 = (1.0 / 35.0) * (
                        delta(j, k) * delta(l, mm)
                        + delta(j, l) * delta(k, mm)
                        + delta(j, mm) * delta(k, l)
                    ) * (rsq * rsq)
                    M4[(j, k, l, mm)] = raw - tr1 + tr2
    # current octupole: sym3(L x x) with traces removed; Tr_i = (1/3) l r^2 z_i
    Tr = {"x": zero, "y": zero, "z": (1.0 / 3.0) * (Lv["z"] * rsq)}
    S3 = {}
    for k in AX:
        for pp in AX:
            for l in AX:
                sym = (1.0 / 3.0) * (
                    Lv[k] * xv[pp] * xv[l]
                    + Lv[pp] * xv[k] * xv[l]
                    + Lv[l] * xv[k] * xv[pp]
                )
                S3[(k, pp, l)] = sym - (1.0 / 5.0) * (
                    delta(k, pp) * Tr[l] + delta(k, l) * Tr[pp] + delta(pp, l) * Tr[k]
                )

    # ---- generic STF machinery for the l = 5, 6 extension ----
    # STF(T) = sym(T) + sum_k c_k sym(delta^k tr^k T); the c_k are solved
    # NUMERICALLY per rank (impose vanishing traces on random symmetric
    # tensors) so no hand-derived double-factorial bookkeeping can slip.
    import itertools
    from functools import lru_cache

    def _pair_partitions(positions, k):
        """All ways to pick k unordered disjoint index pairs from positions
        (remaining positions stay free)."""
        positions = tuple(positions)
        if k == 0:
            return [((), positions)]
        if len(positions) < 2 * k:
            return []
        out = []
        first, rest = positions[0], positions[1:]
        # first position left free
        for pairs, rem in _pair_partitions(rest, k):
            out.append((pairs, (first,) + rem))
        # first position paired
        for i in range(len(rest)):
            pair = (first, rest[i])
            rr = rest[:i] + rest[i + 1:]
            for pairs, rem in _pair_partitions(rr, k - 1):
                out.append(((pair,) + pairs, rem))
        return out

    def _sym_delta_term(u, s, k, idx):
        """sym(delta^k (x) u)_idx for symmetric u of rank s - 2k (numeric or
        Torus entries), averaged over the distinct pairings."""
        parts = _pair_partitions(tuple(range(s)), k)
        total = None
        cnt = 0
        for pairs, rem in parts:
            ok = all(idx[a] == idx[b] for a, b in pairs)
            cnt += 1
            if not ok:
                continue
            val = u[tuple(idx[i] for i in rem)]
            total = val if total is None else total + val
        if total is None:
            return None, cnt
        return (1.0 / cnt) * total, cnt

    def _traces(T, s, k):
        """tr^k of symmetric rank-s tensor dict (contract the last 2k)."""
        out = T
        rank = s
        for _ in range(k):
            nxt = {}
            for idx in itertools.product(AX, repeat=rank - 2):
                acc = None
                for a in AX:
                    v = out[idx + (a, a)]
                    acc = v if acc is None else acc + v
                nxt[idx] = acc
            out = nxt
            rank -= 2
        return out

    def _distinct_perms(key):
        """All distinct permutations of a (possibly repeating) tuple."""
        if not key:
            yield ()
            return
        seen = set()
        for i, a in enumerate(key):
            if a in seen:
                continue
            seen.add(a)
            for rest in _distinct_perms(key[:i] + key[i + 1:]):
                yield (a,) + rest

    @lru_cache(maxsize=None)
    def _stf_coeffs(s):
        """Trace-removal coefficients c_k (k = 1..s//2) for rank s.

        The constraint rows are built only for SORTED leading
        index tuples — for a symmetric tensor every permutation of a lead
        yields the identical trace condition, and the full 3^(s-2)
        enumeration made rank 9/10 (the l = 9, 10 inventory) ~100x more
        expensive for no information.
        """
        rng = np.random.default_rng(12345)
        raw = rng.standard_normal((3,) * s)
        sym = np.zeros_like(raw)
        for perm in itertools.permutations(range(s)):
            sym += np.transpose(raw, perm)
        import math as _math

        sym /= _math.factorial(s)
        tdict = {
            idx: sym[tuple(AX.index(a) for a in idx)]
            for idx in itertools.product(AX, repeat=s)
        }
        kmax = s // 2
        trs = [_traces(tdict, s, k) for k in range(kmax + 1)]
        # unknowns c_1..c_kmax: single trace of (sym + sum c_k sym(d^k tr^k))
        # over the last index pair must vanish for every leading index tuple
        rows = []
        rhs = []
        for lead in itertools.combinations_with_replacement(AX, s - 2):
            coef = np.zeros(kmax)
            base = 0.0
            for a in AX:
                idx = lead + (a, a)
                base += tdict[idx]
                for k in range(1, kmax + 1):
                    v, _ = _sym_delta_term(trs[k], s, k, idx)
                    if v is not None:
                        coef[k - 1] += v
            rows.append(coef)
            rhs.append(-base)
        c, *_ = np.linalg.lstsq(np.array(rows), np.array(rhs), rcond=None)
        # verify
        resid = np.abs(np.array(rows) @ c - np.array(rhs)).max()
        assert resid < 1e-10, f"STF solve failed rank {s}: {resid}"
        return tuple(c)

    def stf(T, s):
        """STF of an already-symmetric rank-s dict with Torus entries.

        Evaluated only at sorted index tuples and mirrored to
        their distinct permutations (input symmetric + delta-trace terms
        symmetric => output symmetric), cutting the rank-10 assembly from
        3^10 x partitions to C(s+2, 2) x partitions Python visits.
        """
        cks = _stf_coeffs(s)
        trs = [None] + [_traces(T, s, k) for k in range(1, s // 2 + 1)]
        out = {}
        for key in itertools.combinations_with_replacement(AX, s):
            val = T[key]
            for k in range(1, s // 2 + 1):
                v, _ = _sym_delta_term(trs[k], s, k, key)
                if v is not None:
                    val = val + cks[k - 1] * v
            for perm in _distinct_perms(key):
                out[perm] = val
        return out

    def mass_moment(s):
        """sym(x^(x)s) as a dict (cached by sorted tuple — x^s is symmetric)."""
        cache = {}
        out = {}
        for idx in itertools.product(AX, repeat=s):
            key = tuple(sorted(idx))
            if key not in cache:
                v = xv[key[0]]
                for a in key[1:]:
                    v = v * xv[a]
                cache[key] = v
            out[idx] = cache[key]
        return stf(out, s)

    def current_moment(s):
        """STF sym of (L x^(s-1)): the rank-s current moment dict."""
        cache = {}
        out = {}
        for idx in itertools.product(AX, repeat=s):
            key = tuple(sorted(idx))
            if key not in cache:
                acc = None
                for i in range(s):
                    v = Lv[key[i]]
                    for j2, a in enumerate(key):
                        if j2 != i:
                            v = v * xv[a]
                    acc = v if acc is None else acc + v
                cache[key] = (1.0 / s) * acc
            out[idx] = cache[key]
        return stf(out, s)

    terms = {}

    tab = Torus({})
    for j in AX:
        for k in AX:
            tab = tab + (w[j] * w[k] * 2.0 * 0.5) * M2[(j, k)]
    terms["T1_quad"] = ([tab.coeffs(od)], [2])

    tab = Torus({})
    for j in AX:
        for k in AX:
            for l in AX:
                tab = tab + (w[j] * w[k] * N[l] * (2.0 / 3.0) * 0.5) * M3[(j, k, l)]
    terms["T2_oct"] = ([tab.coeffs(od)], [3])

    tab = Torus({})
    for j in AX:
        for k in AX:
            for pp in AX:
                for q in AX:
                    e1 = eps[pp + q + j]
                    if e1 != 0.0:
                        tab = tab + (0.5 * (8.0 / 3.0) * e1 * N[q] * w[j] * w[k] * 0.5) * S2[(k, pp)]
                    e2 = eps[pp + q + k]
                    if e2 != 0.0:
                        tab = tab + (0.5 * (8.0 / 3.0) * e2 * N[q] * w[j] * w[k] * 0.5) * S2[(j, pp)]
    terms["T3_curq"] = ([tab.coeffs(od)], [2])

    tab = Torus({})
    for j in AX:
        for k in AX:
            for l in AX:
                for mm in AX:
                    tab = tab + (
                        w[j] * w[k] * N[l] * N[mm] * (1.0 / 6.0) * 0.5
                    ) * M4[(j, k, l, mm)]
    terms["T4_hex"] = ([tab.coeffs(od)], [4])

    tab = Torus({})
    for j in AX:
        for k in AX:
            for pp in AX:
                for q in AX:
                    for l in AX:
                        e1 = eps[pp + q + j]
                        if e1 != 0.0:
                            tab = tab + (0.5 * e1 * N[q] * N[l] * w[j] * w[k] * 0.5) * S3[(k, pp, l)]
                        e2 = eps[pp + q + k]
                        if e2 != 0.0:
                            tab = tab + (0.5 * e2 * N[q] * N[l] * w[j] * w[k] * 0.5) * S3[(j, pp, l)]
    terms["T5_curoct"] = ([tab.coeffs(od)], [3])

    # ---- l = 5, 6 extension (Thorne 4.8 series continued):
    #   mass  l: (4/l!) d^l M_l  w w N^{l-2}
    #   curr  l: (8l/(l+1)!) eps_pq(j d^l S_l k)p A_{l-2} N_q N^{l-2}
    # coefficients: l=4 curr 4/15, l=5 mass 1/30, l=5 curr 1/18,
    # l=6 mass 1/180, l=6 curr 1/105; the extra 0.5 is the h contraction
    # half and the inner 0.5 the (j k) symmetrization, as in T3/T5. ----
    def _rest_combos(s2):
        """Sorted index multisets of length s2 with multiplicities — the
        contracted moments are fully symmetric, so the 3^s2 ordered
        N-index tuples collapse to C(s2+2, 2) weighted terms (the
        rank-9/10 speedup, mirrored in tests/helpers_thorne.py)."""
        import math as _math

        out = []
        for rest in itertools.combinations_with_replacement(AX, s2):
            cnt = _math.factorial(s2)
            for a in set(rest):
                cnt //= _math.factorial(rest.count(a))
            out.append((rest, cnt))
        return out

    def mass_term(s, coeff):
        M = mass_moment(s)
        tab = Torus({})
        for j in AX:
            for k in AX:
                wjk = w[j] * w[k] * coeff * 0.5
                for rest, cnt in _rest_combos(s - 2):
                    wgt = wjk * cnt
                    for a in rest:
                        wgt = wgt * N[a]
                    if wgt != 0.0:
                        tab = tab + wgt * M[(j, k) + rest]
        return tab

    def current_term(s, coeff):
        S = current_moment(s)
        rests = _rest_combos(s - 2)
        tab = Torus({})
        for j in AX:
            for k in AX:
                for pp in AX:
                    for q in AX:
                        e1 = eps[pp + q + j]
                        e2 = eps[pp + q + k]
                        if e1 == 0.0 and e2 == 0.0:
                            continue
                        for rest, cnt in rests:
                            nw = float(cnt)
                            for a in rest:
                                nw *= N[a]
                            if nw == 0.0:
                                continue
                            base = 0.5 * coeff * N[q] * nw * w[j] * w[k] * 0.5
                            if e1 != 0.0:
                                tab = tab + (base * e1) * S[(k, pp) + rest]
                            if e2 != 0.0:
                                tab = tab + (base * e2) * S[(j, pp) + rest]
        return tab

    if l_top >= 4 and l_only <= 4:
        terms["T6_curhex"] = ([current_term(4, 4.0 / 15.0).coeffs(od)], [4])
    if l_top >= 5 and l_only <= 5:
        terms["T7_mass5"] = ([mass_term(5, 1.0 / 30.0).coeffs(od)], [5])
        terms["T8_cur5"] = ([current_term(5, 1.0 / 18.0).coeffs(od)], [5])
    if l_top >= 6 and l_only <= 6:
        terms["T9_mass6"] = ([mass_term(6, 1.0 / 180.0).coeffs(od)], [6])
        terms["T10_cur6"] = ([current_term(6, 1.0 / 105.0).coeffs(od)], [6])
    if l_top >= 7 and l_only <= 7:
        # Thorne 4.8 series continued: mass l coefficient 4/l!, current l
        # coefficient 8l/(l+1)!  ->  l=7: 4/5040 = 1/1260, 56/40320 = 1/720;
        #                             l=8: 4/40320 = 1/10080, 64/362880 = 1/5670
        terms["T11_mass7"] = ([mass_term(7, 1.0 / 1260.0).coeffs(od)], [7])
        terms["T12_cur7"] = ([current_term(7, 1.0 / 720.0).coeffs(od)], [7])
    if l_top >= 8 and l_only <= 8:
        terms["T13_mass8"] = ([mass_term(8, 1.0 / 10080.0).coeffs(od)], [8])
        terms["T14_cur8"] = ([current_term(8, 1.0 / 5670.0).coeffs(od)], [8])
    if l_top >= 9 and l_only <= 9:
        # l=9: mass 4/9! = 1/90720, current 8*9/10! = 1/50400
        terms["T15_mass9"] = ([mass_term(9, 1.0 / 90720.0).coeffs(od)], [9])
        terms["T16_cur9"] = ([current_term(9, 1.0 / 50400.0).coeffs(od)], [9])
    if l_top >= 10 and l_only <= 10:
        # l=10: mass 4/10! = 1/907200, current 8*10/11! = 1/498960
        terms["T17_mass10"] = ([mass_term(10, 1.0 / 907200.0).coeffs(od)], [10])
        terms["T18_cur10"] = ([current_term(10, 1.0 / 498960.0).coeffs(od)], [10])

    return {k: h_of_t(tabs, od, t_grid, Ls) for k, (tabs, Ls) in terms.items()}, od


def fourier_family(od, f_of_r_ell, m):
    """Production-convention F_n of g = f(r, l) e^{i m dphi}, n = -N..N."""
    g = f_of_r_ell(od["r"], od["ell"]) * np.exp(1j * m * od["dphi"])
    ns = np.arange(-N_MAX, N_MAX + 1)
    basis = np.exp(-1j * ns[:, None] * od["th"][None, :])
    return (basis * (od["w"] * g)[None, :]).sum(axis=1)


def model_family(od, Fn, l, m, theta, phi_v, t_grid, sigma=None):
    """h_model(t)/K for family (l, m): A_lmn = K (-i om)^l F_n."""
    import torch

    from emri_frequencydomainwaveforms_tpu_torch.utils.ylm import spin_weighted_ylm

    th_t, ph_t = (torch.tensor(float(v), dtype=torch.float64, device=od["device"])
                  for v in (theta, phi_v))
    yp = [v.cpu().numpy() for v in spin_weighted_ylm([l], [m], th_t, ph_t)]
    ym = [v.cpu().numpy() for v in spin_weighted_ylm([l], [-m], th_t, ph_t)]
    yp = complex(np.asarray(yp[0])[0] + 1j * np.asarray(yp[1])[0])
    ym = complex(np.asarray(ym[0])[0] + 1j * np.asarray(ym[1])[0])
    if sigma is None:
        sigma = (-1.0) ** l
    ns = np.arange(-N_MAX, N_MAX + 1)
    om = m * od["om_phi"] + ns * od["om_r"]
    a_over_k = (-1j * om) ** l * Fn
    h = (a_over_k[None, :] * yp * np.exp(-1j * om[None, :] * t_grid[:, None])).sum(axis=1)
    if m != 0:
        h += (
            sigma * np.conj(a_over_k)[None, :] * ym
            * np.exp(+1j * om[None, :] * t_grid[:, None])
        ).sum(axis=1)
    return h


def fit_constant(h_true, h_per_k):
    """K and relative residual of h_true ~= K h_per_k (complex lsq)."""
    k = np.vdot(h_per_k, h_true) / np.vdot(h_per_k, h_per_k)
    res = np.linalg.norm(h_true - k * h_per_k) / np.linalg.norm(h_true)
    return k, res


def cases_for(l_top=None, l_only=None):
    """The fits: (term, parity, families (l, m, f(r, ell))) through
    ``l_top``, keeping the terms of l >= ``l_only``."""
    l_top = L_TOP if l_top is None else l_top
    l_only = L_ONLY if l_only is None else l_only
    cases = [
        # (term, parity, families: (l, m, f(r, ell)))
        ("T1_quad", +1, [(2, 2, lambda r, l: r**2), (2, 0, lambda r, l: r**2)]),
        ("T2_oct", +1, [(3, 3, lambda r, l: r**3), (3, 1, lambda r, l: r**3)]),
        ("T3_curq", -1, [(2, 1, lambda r, l: l * r)]),
        ("T4_hex", +1, [(4, 4, lambda r, l: r**4), (4, 2, lambda r, l: r**4),
                     (4, 0, lambda r, l: r**4)]),
        ("T5_curoct", -1, [(3, 2, lambda r, l: l * r**2), (3, 0, lambda r, l: l * r**2)]),
        ("T6_curhex", -1, [(4, 3, lambda r, l: l * r**3), (4, 1, lambda r, l: l * r**3)]),
    ]
    if l_top >= 5:
        cases += [
            ("T7_mass5", +1, [(5, 5, lambda r, l: r**5), (5, 3, lambda r, l: r**5),
                              (5, 1, lambda r, l: r**5)]),
            ("T8_cur5", -1, [(5, 4, lambda r, l: l * r**4), (5, 2, lambda r, l: l * r**4),
                             (5, 0, lambda r, l: l * r**4)]),
        ]
    if l_top >= 6:
        cases += [
            ("T9_mass6", +1, [(6, 6, lambda r, l: r**6), (6, 4, lambda r, l: r**6),
                              (6, 2, lambda r, l: r**6), (6, 0, lambda r, l: r**6)]),
            ("T10_cur6", -1, [(6, 5, lambda r, l: l * r**5), (6, 3, lambda r, l: l * r**5),
                              (6, 1, lambda r, l: l * r**5)]),
        ]
    if l_top >= 7:
        cases += [
            ("T11_mass7", +1, [(7, m, lambda r, l: r**7) for m in (7, 5, 3, 1)]),
            ("T12_cur7", -1, [(7, m, lambda r, l: l * r**6) for m in (6, 4, 2, 0)]),
        ]
    if l_top >= 8:
        cases += [
            ("T13_mass8", +1, [(8, m, lambda r, l: r**8) for m in (8, 6, 4, 2, 0)]),
            ("T14_cur8", -1, [(8, m, lambda r, l: l * r**7) for m in (7, 5, 3, 1)]),
        ]
    if l_top >= 9:
        cases += [
            ("T15_mass9", +1, [(9, m, lambda r, l: r**9) for m in (9, 7, 5, 3, 1)]),
            ("T16_cur9", -1, [(9, m, lambda r, l: l * r**8) for m in (8, 6, 4, 2, 0)]),
        ]
    if l_top >= 10:
        cases += [
            ("T17_mass10", +1,
             [(10, m, lambda r, l: r**10) for m in (10, 8, 6, 4, 2, 0)]),
            ("T18_cur10", -1,
             [(10, m, lambda r, l: l * r**9) for m in (9, 7, 5, 3, 1)]),
        ]
    return [c for c in cases if int(c[2][0][0]) >= l_only]


P_FIT, E_FIT = 10.0, 0.37
ANGLES = [(0.8, 0.3), (1.9, 2.2), (2.6, 5.1)]


def derive(l_top=None, l_only=None, device=None, p=P_FIT, e=E_FIT, angles=ANGLES):
    """Fit every family's K_lm: [(term, relative residual, [(l, m, K)])]."""
    od0 = orbit_data(p, e, device)
    t_grid = np.linspace(0.0, 3.1 * 2 * np.pi / od0["om_r"], 173)
    cases = cases_for(l_top, l_only)
    # brute force once per angle (the rank-l STF assembly dominates)
    bf_cache = {a: brute_force_terms(p, e, a[0], a[1], t_grid, l_top, l_only, device)
                for a in angles}
    out = []
    for term, parity, fams in cases:
        # stack several viewing angles so families with different m separate
        h_true = []
        per_k = {f[: 2]: [] for f in fams}
        for th, ph in angles:
            ht, od = bf_cache[(th, ph)]
            h_true.append(ht[term])
            for (l, m, fr) in fams:
                Fn = fourier_family(od, fr, m)
                sigma = parity * (-1.0) ** l
                per_k[(l, m)].append(
                    model_family(od, Fn, l, m, th, ph, t_grid, sigma=sigma)
                )
        h_true = np.concatenate(h_true)
        basis = np.stack([np.concatenate(per_k[f[:2]]) for f in fams], axis=1)
        kvec, *_ = np.linalg.lstsq(basis, h_true, rcond=None)
        resid = np.linalg.norm(h_true - basis @ kvec) / np.linalg.norm(h_true)
        out.append((term, float(resid), [(l, m, complex(k)) for (l, m, _), k in zip(fams, kvec)]))
    return out


def against_amplitude_constants(fits):
    """{(l, m): |K_lm (-i)^l - C_lm| / |C_lm|} against the constants of the
    port's ``models/amplitude.py`` (``_FAMILIES``)."""
    from emri_frequencydomainwaveforms_tpu_torch.models.amplitude import _FAMILIES

    out = {}
    for _, _, ks in fits:
        for l, m, k in ks:
            c = complex(*_FAMILIES[(l, m)][3:5])
            out[(l, m)] = abs(k * (-1j) ** l - c) / abs(c)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the orbit and Ylm (default: the current CUDA device)")
    args = ap.parse_args(argv)
    from fractions import Fraction

    fits = derive(device=args.device)
    for term, resid, ks in fits:
        print(f"== {term}: residual {resid:.3e}")
        for l, m, k in ks:
            print(f"   K_{l}{m} = {k.real:+.18e} {k.imag:+.18e}j")
            mag2 = (abs(k) ** 2) / np.pi
            frac = Fraction(mag2).limit_denominator(10**9)
            err = abs(float(frac) - mag2) / mag2
            ang = np.angle(k) / (np.pi / 2)  # multiples of 90 deg
            print(
                f"      |K|^2/pi = {mag2:.12f} ~ {frac} (rel err {err:.1e}),"
                f" phase = {ang:+.6f} * pi/2"
            )
    dev = against_amplitude_constants(fits)
    worst = max(dev, key=dev.get)
    print(f"against models/amplitude.py: worst |K_lm (-i)^l - C_lm| / |C_lm| "
          f"{dev[worst]:.3e} at (l, m) = {worst} over {len(dev)} families")
    return fits, dev


if __name__ == "__main__":
    main()
