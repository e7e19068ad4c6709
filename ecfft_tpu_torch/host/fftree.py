"""The host oracle: an exact python-int FFTree with all eight ECFFT
algorithms (ENTER, EXIT, DEGREE, EXTEND, MEXTEND, MOD, REDC, VANISH).

A jax-free copy of ``ecfft_tpu/host/fftree.py`` (every class and function
has its original's source, tested). It is an implementation independent
of the port's schedule machine and of the native engine, so it serves as a
third witness of both: the recursive shape of the reference's FFTree
(reference/src/fftree.rs) over a duck-typed field object, ``FpHost`` for
a prime field (a plain prime is wrapped in one) or ``F2m`` for GF(2^m).

- moieties: S0 = even-indexed leaves, S1 = odd-indexed leaves;
  extend(evals, S1) means "input on S0 → values on S1";
- the subtree's layers are the even-indexed entries of every layer, less
  the last rational map (fftree.rs:465-482);
- the bootstrap runs matrices → z0_s1 → z1_s0 → the z0z0/z1z1 remainder
  tables, in that order (fftree.rs:318-463).

``build_host_fftree(field_name, n)`` builds one over a registered prime
field; ``build_host_fftree_even(field, n)`` one over a binary field
(``fields.binary.GF512``), the reference's even-characteristic good curve
taken to a working tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ecfft_tpu_torch.fields.host import FpHost

S0 = 0  # moiety S0 (even leaf positions)
S1 = 1  # moiety S1 (odd leaf positions)


def _as_field(p_or_field):
    """int → FpHost; anything else must already be a field object."""
    return FpHost(p_or_field) if isinstance(p_or_field, int) else p_or_field


def _mat2_inv(m: list[list[int]], F) -> list[list[int]]:
    det = F.sub(F.mul(m[0][0], m[1][1]), F.mul(m[0][1], m[1][0]))
    di = F.inv(det)
    return [
        [F.mul(m[1][1], di), F.neg(F.mul(m[0][1], di))],
        [F.neg(F.mul(m[1][0], di)), F.mul(m[0][0], di)],
    ]


def _evaluate(F, coeffs, x: int) -> int:
    """Horner evaluation of a low-degree-first coefficient list over F."""
    acc = 0
    for c in reversed(list(coeffs)):
        acc = F.add(F.mul(acc, x), c)
    return acc


@dataclass
class HostFFTree:
    F: object  # duck-typed field (FpHost, F2m, ...)
    # f_layers[0] = leaves (size n), f_layers[i] halves each level, up to [root]
    f_layers: list[list[int]]
    # matrix layers: decompose/recombine_layers[i] has n/2^(i+1) 2x2 matrices
    recombine_layers: list[list[list[list[int]]]]
    decompose_layers: list[list[list[list[int]]]]
    rational_maps: list
    subtree: "HostFFTree | None"
    xnn_s: list[int] = field(default_factory=list)
    xnn_s_inv: list[int] = field(default_factory=list)
    z0_s1: list[int] = field(default_factory=list)
    z1_s0: list[int] = field(default_factory=list)
    z0_inv_s1: list[int] = field(default_factory=list)
    z1_inv_s0: list[int] = field(default_factory=list)
    z0z0_rem_xnn_s: list[int] = field(default_factory=list)
    z1z1_rem_xnn_s: list[int] = field(default_factory=list)

    @property
    def p(self) -> int:
        """Field characteristic (prime-field trees: the modulus)."""
        return self.F.characteristic

    # ---------------------------------------------------------------- build

    @classmethod
    def build(cls, leaves: list[int], rational_maps: list,
              p) -> "HostFFTree":
        """FFTree::new (fftree.rs:42-70): fill internal domain layers by
        applying rational map i to layer i, then run the bootstrap.
        ``p``: a prime modulus or a field object."""
        F = _as_field(p)
        n = len(leaves)
        assert n & (n - 1) == 0
        log_n = n.bit_length() - 1
        assert log_n == len(rational_maps)
        f_layers = [list(leaves)]
        for i, rmap in enumerate(rational_maps):
            prev = f_layers[-1]
            half = len(prev) // 2
            layer = []
            for j in range(half):
                v = rmap(prev[j])
                assert v is not None
                # 2-to-1 map property (fftree.rs:65)
                assert v == rmap(prev[j + half])
                layer.append(v)
            f_layers.append(layer)
        return cls.from_layers(f_layers, rational_maps, F)

    @classmethod
    def from_layers(cls, f_layers: list[list[int]],
                    rational_maps: list, p) -> "HostFFTree":
        """from_tree (fftree.rs:318-463)."""
        F = _as_field(p)
        n = len(f_layers[0])
        subtree = cls._derive_subtree(f_layers, rational_maps, F)
        s = f_layers[0]
        nn = n // 2
        nnnn = n // 4

        xnnnn_s = [F.pow(x, nnnn) for x in s]
        xnnnn_s_inv = F.batch_inv(xnnnn_s)
        xnn_s = [F.pow(x, nn) for x in s]
        xnn_s_inv = F.batch_inv(xnn_s)

        s0 = s[0::2]
        s1 = s[1::2]

        # decomposition matrices, Lemma 3.2 of ECFFT-I (fftree.rs:338-363)
        recombine_layers: list = []
        decompose_layers: list = []
        num_mat_layers = max(n.bit_length() - 1, 0)
        for li in range(num_mat_layers):
            size = n >> (li + 1)
            ident = [[1, 0], [0, 1]]
            recombine_layers.append([[r[:] for r in ident] for _ in range(size)])
            decompose_layers.append([[r[:] for r in ident] for _ in range(size)])
        for li, (layer, rmap) in enumerate(zip(f_layers, rational_maps)):
            d = len(layer) // 2
            if d == 1:
                continue  # identity matrices at the 2-wide layer
            v = list(rmap.denominator)
            e = d // 2 - 1
            for i in range(d):
                sa = layer[i]
                sb = layer[i + d]
                v0 = F.pow(_evaluate(F, v, sa), e)
                v1 = F.pow(_evaluate(F, v, sb), e)
                rmat = [[v0, F.mul(sa, v0)], [v1, F.mul(sb, v1)]]
                recombine_layers[li][i] = rmat
                decompose_layers[li][i] = _mat2_inv(rmat, F)

        tree = cls(
            F=F,
            f_layers=f_layers,
            recombine_layers=recombine_layers,
            decompose_layers=decompose_layers,
            rational_maps=list(rational_maps),
            subtree=subtree,
            xnn_s=xnn_s,
            xnn_s_inv=xnn_s_inv,
        )

        # bootstrap z tables (fftree.rs:381-460)
        if n > 2:
            st = tree.subtree
            st_z0_s0 = [y for z in st.z0_s1 for y in (0, z)]
            st_z1_s0 = [y for z in st.z1_s0 for y in (z, 0)]
            st_z0_s1 = tree.extend(st_z0_s0, S1)
            st_z1_s1 = tree.extend(st_z1_s0, S1)
            tree.z0_s1 = [F.mul(a, b) for a, b in zip(st_z0_s1, st_z1_s1)]
            z1_s = tree.vanish(s1)
            tree.z1_s0 = z1_s[0::2]
        elif n == 2:
            tree.z0_s1 = [F.sub(s1[0], s0[0])]
            tree.z1_s0 = [F.sub(s0[0], s1[0])]

        tree.z0_inv_s1 = F.batch_inv(tree.z0_s1)
        tree.z1_inv_s0 = F.batch_inv(tree.z1_s0)

        if n > 2:
            st = tree.subtree
            # z0z0_rem_xnn_s in O(n log n) (fftree.rs:419-446)
            z0_rem_xnnnn_sq_s0 = [
                F.mul(a, b)
                for a, b in zip(st.z0z0_rem_xnn_s, st.z1z1_rem_xnn_s)
            ]
            z0z0_rem_xnnnn_s0 = st.modular_reduce(
                z0_rem_xnnnn_sq_s0, st.xnn_s, st.z0z0_rem_xnn_s
            )
            z0z0_rem_xnnnn_s1 = tree.extend(z0z0_rem_xnnnn_s0, S1)
            z0z0_rem_xnnnn_s = [
                y for ab in zip(z0z0_rem_xnnnn_s0, z0z0_rem_xnnnn_s1) for y in ab
            ]
            z0_s = [y for z in tree.z0_s1 for y in (0, z)]
            z0_rem_xnn_sq_s = [
                F.square(F.sub(z0, xnn)) for z0, xnn in zip(z0_s, tree.xnn_s)
            ]
            z0_rem_xnn_sq_div_xnnnn_s = [
                F.mul(F.sub(sq, rem), xi)
                for sq, rem, xi in zip(
                    z0_rem_xnn_sq_s, z0z0_rem_xnnnn_s, xnnnn_s_inv
                )
            ]
            z0z0_div_xnnnn_rem_xnnnn_s = tree.modular_reduce(
                z0_rem_xnn_sq_div_xnnnn_s, xnnnn_s, z0z0_rem_xnnnn_s
            )
            tree.z0z0_rem_xnn_s = [
                F.add(lo, F.mul(x, hi))
                for lo, hi, x in zip(
                    z0z0_rem_xnnnn_s, z0z0_div_xnnnn_rem_xnnnn_s, xnnnn_s
                )
            ]
            # z1z1_rem_xnn_s (fftree.rs:448-452)
            z1_s = [y for z in tree.z1_s0 for y in (z, 0)]
            z1z1 = [
                F.square(F.sub(z1, xnn)) for z1, xnn in zip(z1_s, tree.xnn_s)
            ]
            tree.z1z1_rem_xnn_s = tree.modular_reduce(
                z1z1, tree.xnn_s, tree.z0z0_rem_xnn_s
            )
        elif n == 2:
            tree.z0z0_rem_xnn_s = [F.square(s0[0])] * 2
            tree.z1z1_rem_xnn_s = [F.square(s1[0])] * 2

        return tree

    @classmethod
    def _derive_subtree(cls, f_layers, rational_maps, F) -> "HostFFTree | None":
        """Even-indexed entries of every layer; drop the last rational map
        (fftree.rs:465-482)."""
        n = len(f_layers[0]) // 2
        if n == 0:
            return None
        sub_layers = [layer[0::2] for layer in f_layers[:-1]]
        return cls.from_layers(sub_layers, rational_maps[:-1], F)

    # ------------------------------------------------------------ accessors

    @property
    def n(self) -> int:
        return len(self.f_layers[0])

    def eval_domain(self) -> list[int]:
        return self.f_layers[0]

    def subtree_with_size(self, n: int) -> "HostFFTree":
        """Walk the chain so one big tree serves all sizes ≤ its own
        (fftree.rs:489-496)."""
        assert n & (n - 1) == 0
        if n < self.n:
            return self.subtree.subtree_with_size(n)
        if n == self.n:
            return self
        raise ValueError("FFTree is too small")

    # ----------------------------------------------------------- algorithms

    def _extend_impl(self, evals: list[int], moiety: int) -> list[int]:
        """EXTEND core (fftree.rs:72-120): decompose through the layer's
        2x2 matrices, recurse at half size, recombine."""
        F = self.F
        n = len(evals)
        if n == 1:
            return list(evals)
        log_n = n.bit_length() - 1
        # reference: layer = num_layers(f) - 2 - log2(n); with our layer
        # list indexed from leaves this is simply log2(self.n) - 1 - log2(n)
        layer = (self.n.bit_length() - 1) - 1 - log_n

        half = n // 2
        dec = self.decompose_layers[layer]
        skip = 1 if moiety == S0 else 0
        evals0 = [0] * half
        evals1 = [0] * half
        for i in range(half):
            m = dec[skip + 2 * i]
            a, b = evals[i], evals[i + half]
            evals0[i] = F.add(F.mul(m[0][0], a), F.mul(m[0][1], b))
            evals1[i] = F.add(F.mul(m[1][0], a), F.mul(m[1][1], b))

        e0p = self._extend_impl(evals0, moiety)
        e1p = self._extend_impl(evals1, moiety)

        rec = self.recombine_layers[layer]
        skip = 0 if moiety == S0 else 1
        res = [0] * n
        for i in range(half):
            m = rec[skip + 2 * i]
            a, b = e0p[i], e1p[i]
            res[i] = F.add(F.mul(m[0][0], a), F.mul(m[0][1], b))
            res[i + half] = F.add(F.mul(m[1][0], a), F.mul(m[1][1], b))
        return res

    def extend(self, evals: list[int], moiety: int) -> list[int]:
        """extend(evals, S1): input on S0 → output on S1 (fftree.rs:123-126)."""
        return self.subtree_with_size(len(evals) * 2)._extend_impl(evals, moiety)

    def _mextend_impl(self, evals: list[int], moiety: int) -> list[int]:
        e = self._extend_impl(evals, moiety)
        z = self.z0_s1 if moiety == S1 else self.z1_s0
        return [self.F.add(a, b) for a, b in zip(e, z)]

    def mextend(self, evals: list[int], moiety: int) -> list[int]:
        """EXTEND for monic polys of degree exactly n/2 (fftree.rs:128-141)."""
        return self.subtree_with_size(len(evals) * 2)._mextend_impl(evals, moiety)

    def _enter_impl(self, coeffs: list[int]) -> list[int]:
        """ENTER (fft): coeffs → evals (fftree.rs:143-161)."""
        F = self.F
        n = len(coeffs)
        if n == 1:
            return list(coeffs)
        st = self.subtree
        u0 = st.enter(coeffs[: n // 2])
        v0 = st.enter(coeffs[n // 2 :])
        u1 = self.extend(u0, S1)
        v1 = self.extend(v0, S1)
        res = []
        for i in range(n // 2):
            res.append(F.add(u0[i], F.mul(v0[i], self.xnn_s[2 * i])))
            res.append(F.add(u1[i], F.mul(v1[i], self.xnn_s[2 * i + 1])))
        return res

    def enter(self, coeffs: list[int]) -> list[int]:
        return self.subtree_with_size(len(coeffs))._enter_impl(coeffs)

    def _degree_impl(self, evals: list[int]) -> int:
        """DEGREE (fftree.rs:169-192)."""
        F = self.F
        n = len(evals)
        if n == 1:
            return 0
        st = self.subtree
        e0 = evals[0::2]
        e1 = evals[1::2]
        g1 = self._extend_impl(e0, S1)
        if g1 == e1:
            return st._degree_impl(e0)
        t1 = [
            F.mul(F.sub(b, g), zi)
            for b, g, zi in zip(e1, g1, self.z0_inv_s1)
        ]
        t0 = self._extend_impl(t1, S0)
        return n // 2 + st._degree_impl(t0)

    def degree(self, evals: list[int]) -> int:
        return self.subtree_with_size(len(evals))._degree_impl(evals)

    def _exit_impl(self, evals: list[int]) -> list[int]:
        """EXIT (ifft): evals → coeffs (fftree.rs:200-224)."""
        F = self.F
        n = len(evals)
        if n == 1:
            return list(evals)
        u0 = self._modular_reduce_impl(
            evals, self.xnn_s, self.z0z0_rem_xnn_s
        )[0::2]
        st = self.subtree
        a = st._exit_impl(u0)
        v0 = [
            F.mul(F.sub(e, u), xi)
            for e, u, xi in zip(evals[0::2], u0, self.xnn_s_inv[0::2])
        ]
        b = st._exit_impl(v0)
        return a + b

    def exit(self, evals: list[int]) -> list[int]:
        return self.subtree_with_size(len(evals))._exit_impl(evals)

    def _redc_impl(self, evals: list[int], a: list[int], moiety: int) -> list[int]:
        """Polynomial Montgomery REDC: <P·Z⁻¹ mod a ≀ S> (fftree.rs:232-259)."""
        F = self.F
        e0, e1 = evals[0::2], evals[1::2]
        a0, a1 = a[0::2], a[1::2]
        a0_inv = F.batch_inv(a0)
        t0 = [F.mul(e, ai) for e, ai in zip(e0, a0_inv)]
        g1 = self._extend_impl(t0, S0 if moiety == S1 else S1)
        z_inv = self.z0_inv_s1 if moiety == S0 else self.z1_inv_s0
        h1 = [
            F.mul(F.sub(e, F.mul(g, av)), zi)
            for e, g, av, zi in zip(e1, g1, a1, z_inv)
        ]
        h0 = self._extend_impl(h1, moiety)
        return [y for hh in zip(h0, h1) for y in hh]

    def redc_z0(self, evals: list[int], a: list[int]) -> list[int]:
        return self.subtree_with_size(len(evals))._redc_impl(evals, a, S0)

    def redc_z1(self, evals: list[int], a: list[int]) -> list[int]:
        return self.subtree_with_size(len(evals))._redc_impl(evals, a, S1)

    def _modular_reduce_impl(self, evals, a, c) -> list[int]:
        """MOD = REDC ∘ (·c) ∘ REDC (fftree.rs:277-281)."""
        h = self._redc_impl(evals, a, S0)
        hc = [self.F.mul(x, y) for x, y in zip(h, c)]
        return self._redc_impl(hc, a, S0)

    def modular_reduce(self, evals, a, c) -> list[int]:
        return self.subtree_with_size(len(evals))._modular_reduce_impl(evals, a, c)

    def _vanish_impl(self, domain: list[int]) -> list[int]:
        """VANISH: eval of Z(x)=∏(x−aᵢ) over S (fftree.rs:291-308,
        ECFFT-I §7.1 product tree)."""
        F = self.F
        n = len(domain)
        if n == 1:
            leaves = self.f_layers[0]
            assert len(leaves) == 2
            alpha = domain[0]
            return [F.sub(alpha, leaves[0]), F.sub(alpha, leaves[1])]
        st = self.subtree
        qp = st._vanish_impl(domain[: n // 2])
        qpp = st._vanish_impl(domain[n // 2 :])
        q_s0 = [F.mul(a, b) for a, b in zip(qp, qpp)]
        q_s1 = self.mextend(q_s0, S1)
        return [y for q in zip(q_s0, q_s1) for y in q]

    def vanish(self, domain: list[int]) -> list[int]:
        return self.subtree_with_size(len(domain) * 2)._vanish_impl(domain)


def build_host_fftree(field_name: str, n: int) -> HostFFTree | None:
    """F::build_fftree(n) analogue (lib.rs:14-16) on the host oracle."""
    from ecfft_tpu_torch.fields.registry import build_domain, get_spec

    spec = get_spec(field_name)
    dom = build_domain(spec, n)
    if dom is None:
        return None
    leaves, maps = dom
    return HostFFTree.build(leaves, maps, spec.p)


# Known maximal-2-adicity generators, field.order -> (b, x, y, adicity):
# the same role as the reference's hardcoded curve constants
# (lib.rs:45-59). Each seed is re-VERIFIED at build time (on-curve +
# exact 2-adicity), so a wrong entry falls back to the exhaustive
# search rather than corrupting the tree.
_EVEN_GENERATOR_SEEDS = {
    512: (2, 7, 466, 9),  # GF(2^9), found by the exhaustive search below
}


def build_host_fftree_even(field, n: int) -> HostFFTree | None:
    """FFTree over a binary field GF(2^m) — the reference's
    `GoodCurve::Even` capability (ec.rs:28-35,63-73) taken all the way to
    a working FFTree, which the reference itself never does.

    Domain: a coset of the order-n cyclic 2-Sylow subgroup generated by
    walking ``offset + i·generator`` (lib.rs:72-79's pattern); maps: the
    x-coordinate rational maps of the even closed-form isogeny chain.
    Returns None when no suitable generator exists (lib.rs:62-64).
    """
    from ecfft_tpu_torch.ec.binary import (
        GoodCurveEven,
        PointB,
        curve_points,
        find_isogeny_chain_even,
    )
    from ecfft_tpu_torch.ec.curve import two_adicity

    assert n & (n - 1) == 0 and n >= 2
    log_n = n.bit_length() - 1
    # find a curve point of maximal 2-adicity to act as subgroup generator.
    # The coset offset needs adicity ≥ log n + 2: with a cyclic 2-Sylow
    # that guarantees 2·offset ∉ <g>, so the coset offset + <g> contains
    # no ±-pairs and all leaf x-coordinates are distinct (the analogue of
    # the reference's coset-offset choice, lib.rs:45-59).
    best, best_k = None, 0
    seed = _EVEN_GENERATOR_SEEDS.get(field.order)
    if seed is not None:
        b, x, y, k = seed
        curve = GoodCurveEven.new_even(field, b)
        # the seed is VERIFIED, not trusted: on-curve + exact 2-adicity
        if curve.contains(x, y):
            pt = PointB(x, y, curve)
            if two_adicity(pt) == k:
                best, best_k = pt, k
    if best is None or best_k < log_n + 2:
        best, best_k = None, 0
        for b in range(1, field.order):
            curve = GoodCurveEven.new_even(field, b)
            for pt in curve_points(curve):
                k = two_adicity(pt)
                if k is not None and k > best_k:
                    best, best_k = pt, k
            if best_k >= log_n + 2:
                break
    if best is None or best_k < log_n + 2:
        return None  # subgroup two-adicity insufficient (lib.rs:62-64)
    # halve down so the generator's order is exactly n
    g = best
    for _ in range(best_k - log_n):
        g = g.double()
    offset = best
    acc = offset
    leaves = []
    for _ in range(n):
        leaves.append(acc.x)
        acc = acc + g
    assert len(set(leaves)) == n, "coset x-coordinates must be distinct"
    chain = find_isogeny_chain_even(g)
    assert len(chain) == log_n
    maps = [iso.r for iso in chain]
    return HostFFTree.build(leaves, maps, field)
