"""Exact Gaussian-process arithmetic on sorted 1-D inputs, in plain PyTorch.

The covariance ``K = k(x_i - x_j) + diag`` of a kernel that decays with
distance is held block-tridiagonal: the kernel's ``cutoff`` is the distance
beyond which it stays under ``CUTOFF_REL`` of its value at 0 (0 beyond a
compact support), and the block size ``b`` is the most points that lie
within the cutoff of one point, so every entry outside the two block
diagonals is at least a cutoff away. Entries inside them are kept whatever
their size. The last block is padded with unit-diagonal rows.

On that layout: the block Cholesky factor ``L`` (diagonal blocks ``L_p``,
sub-diagonal blocks ``W_p = E_p L_{p-1}^{-T}``), solves, the log-likelihood
and its gradient (autograd through the factorization to the kernel blocks,
then one block at a time to the parameters), the predictive mean and
variance, and stochastic Lanczos quadrature of ``log det K`` over given
probes with full reorthogonalization.

``Precision("float64")`` is the reference. ``Precision("tf32")`` is the
control: float32, with the operands of every matrix product rounded to
TF32's 10-bit mantissa, as the card's TF32 tensor cores take them.
"""

import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
# the kernel's entries beyond the cutoff stay under this share of k(0)
CUTOFF_REL = 1e-15
# the cutoff is looked for on a grid of this many distances over the span
# of the data
CUTOFF_GRID = 1 << 16


def round_tf32(t):
    """``t`` (float32) rounded to the nearest value with TF32's 10-bit
    mantissa; its derivative is taken as the identity's."""
    i = t.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & -0x2000).view(torch.float32)
    return t + (r - t).detach() if t.requires_grad else r


class Precision(object):
    """The arithmetic of one evaluation: ``"float64"`` or ``"tf32"``."""

    def __init__(self, name):
        if name not in ("float64", "tf32"):
            raise ValueError("precision is float64 or tf32, not %r" % name)
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a, b):
        if self.name == "tf32":
            return round_tf32(a) @ round_tf32(b)
        return a @ b


class BandedGP(object):
    """A zero-mean GP with kernel ``node`` (:mod:`.kernel`) on sorted
    ``x`` ``(n,)`` with noise variances ``diag`` ``(n,)`` (float64 numpy),
    evaluated on ``device`` in ``precision``. ``min_block`` is the least
    block size (larger blocks make fewer, larger products)."""

    def __init__(self, node, x, diag, device, precision="float64",
                 min_block=256):
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 1 or np.any(np.diff(x) < 0):
            raise ValueError("the reference takes sorted 1-D inputs")
        self.node = node
        self.prec = Precision(precision)
        self.device = torch.device(device)
        self.x = x
        self.diag = np.asarray(diag, dtype=np.float64)
        self.n = len(x)
        self.min_block = int(min_block)

    # -- layout -----------------------------------------------------------

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.prec.dtype)

    def cutoff(self, theta):
        """The distance beyond which ``|k|`` stays under ``CUTOFF_REL``
        of ``k(0)`` (on the grid over the data's span)."""
        span = float(self.x[-1] - self.x[0])
        d = torch.linspace(0.0, span, CUTOFF_GRID, dtype=torch.float64)
        with torch.no_grad():
            k = torch.abs(self.node.fn(torch.as_tensor(
                theta, dtype=torch.float64), d))
        above = torch.nonzero(k > CUTOFF_REL * k[0]).max().item()
        return float(d[min(above + 1, CUTOFF_GRID - 1)])

    def layout(self, theta):
        """``(b, nb)``: the block size and the number of blocks."""
        c = self.cutoff(theta)
        ends = np.searchsorted(self.x, self.x + c, side="left")
        b = int(np.max(ends - np.arange(self.n)))
        b = min(max(b, self.min_block), self.n)
        return b, -(-self.n // b)

    def _blocked(self, v, b, nb, fill):
        out = np.full(nb * b, fill, dtype=np.float64)
        out[:self.n] = v
        return out.reshape(nb, b)

    def _prep(self, theta):
        b, nb = self.layout(theta)
        xb = self._t(self._blocked(self.x, b, nb, self.x[-1]))
        valid = self._t(self._blocked(np.ones(self.n), b, nb, 0.0))
        diag = self._t(self._blocked(self.diag, b, nb, 1.0))
        return b, nb, xb, valid, diag

    def _kblock(self, th, xb, valid, diag, p, q):
        """Block ``(p, q)`` of ``K`` (``q`` is ``p`` or ``p - 1``)."""
        K = self.node.fn(th, xb[p][:, None] - xb[q][None, :])
        K = K * (valid[p][:, None] * valid[q][None, :])
        if p == q:
            K = K + torch.diag(diag[p])
        return K

    # -- factorization and solves ------------------------------------------

    def _factor(self, D, E):
        """Block Cholesky of the diagonal blocks ``D`` and sub-diagonal
        blocks ``E`` (``E[0]`` unused): ``(Ls, Ws)``, NaN blocks where a
        pivot block is not positive definite."""
        Ls, Ws = [], [None]
        for p in range(len(D)):
            S = D[p]
            if p:
                Wt = torch.linalg.solve_triangular(Ls[-1], E[p].mT,
                                                   upper=False)
                W = Wt.mT
                S = S - self.prec.mm(W, Wt)
                Ws.append(W)
            L, info = torch.linalg.cholesky_ex(S)
            if int(info) != 0:
                L = torch.full_like(S, float("nan"))
            Ls.append(L)
        return Ls, Ws

    def _forward(self, Ls, Ws, R):
        """``L^{-1} R`` for ``R`` ``(nb, b, k)``, as a list of blocks."""
        Z = []
        for p in range(len(Ls)):
            rhs = R[p] if p == 0 else R[p] - self.prec.mm(Ws[p], Z[-1])
            Z.append(torch.linalg.solve_triangular(Ls[p], rhs, upper=False))
        return Z

    def _backward(self, Ls, Ws, Z):
        """``L^{-T} Z`` for the blocks ``Z``, as a list of blocks."""
        nb = len(Ls)
        X = [None] * nb
        for p in reversed(range(nb)):
            rhs = Z[p] if p == nb - 1 else Z[p] - self.prec.mm(
                Ws[p + 1].mT, X[p + 1])
            X[p] = torch.linalg.solve_triangular(Ls[p].mT, rhs, upper=True)
        return X

    def _rhs(self, V, b, nb):
        """``V`` ``(n,)`` or ``(n, k)`` numpy as blocks ``(nb, b, k)``,
        padded with zero rows."""
        V = np.asarray(V, dtype=np.float64)
        V = V[:, None] if V.ndim == 1 else V
        out = np.zeros((nb * b, V.shape[1]))
        out[:self.n] = V
        return self._t(out.reshape(nb, b, V.shape[1]))

    def _blocks(self, th, prep):
        b, nb, xb, valid, diag = prep
        D = [self._kblock(th, xb, valid, diag, p, p) for p in range(nb)]
        E = [None] + [self._kblock(th, xb, valid, diag, p, p - 1)
                      for p in range(1, nb)]
        return D, E

    def _theta(self, theta):
        return torch.as_tensor(np.asarray(theta, dtype=np.float64),
                               device=self.device).to(self.prec.dtype)

    # -- the exact log-likelihood -------------------------------------------

    def loglike_and_grad(self, theta, y):
        """The exact log-likelihood of ``y`` at the kernel parameters
        ``theta`` (the full vector, george's order) and its gradient in
        every parameter, as ``(float, numpy (p,))``."""
        prep = self._prep(theta)
        b, nb = prep[0], prep[1]
        th = self._theta(theta)
        with torch.no_grad():
            D, E = self._blocks(th, prep)
        leaves = [t.requires_grad_() for t in D + E[1:]]
        Ls, Ws = self._factor(D, E)
        if any(bool(torch.isnan(L[0, 0])) for L in Ls):
            return float("nan"), np.full(len(theta), np.nan)
        Z = self._forward(Ls, Ws, self._rhs(y, b, nb))
        quad = sum(torch.sum(z * z) for z in Z)
        logdet = 2.0 * sum(torch.sum(torch.log(torch.diagonal(L)))
                           for L in Ls)
        ll = -0.5 * (quad + logdet + self.n * LOG_2PI)
        grads = torch.autograd.grad(ll, leaves)
        del Ls, Ws, Z, leaves
        value = float(ll.detach())
        # chain rule to the parameters, one block at a time
        _, _, xb, valid, diag = prep
        th = th.clone().requires_grad_()
        g = torch.zeros_like(th)
        for p in range(nb):
            blocks = [(p, p, grads[p])]
            if p:
                blocks.append((p, p - 1, grads[nb + p - 1]))
            for i, j, gb in blocks:
                K = self._kblock(th, xb, valid, diag, i, j)
                g = g + torch.autograd.grad(K, th, gb)[0]
        return value, g.detach().cpu().numpy().astype(np.float64)

    # -- prediction ---------------------------------------------------------

    def predictor(self, theta, y):
        """``predict(t) -> (mean, var)`` numpy at test points ``t`` ``(m,)``,
        the factorization at ``theta`` made once."""
        prep = self._prep(theta)
        b, nb, xb, valid, _ = prep
        th = self._theta(theta)
        with torch.no_grad():
            Ls, Ws = self._factor(*self._blocks(th, prep))
            alpha = self._backward(Ls, Ws, self._forward(
                Ls, Ws, self._rhs(y, b, nb)))
            k0 = self.node.fn(th, torch.zeros(1, dtype=th.dtype,
                                              device=self.device))

        def predict(t):
            ts = self._t(np.asarray(t, dtype=np.float64))
            with torch.no_grad():
                Ks = [self.node.fn(th, ts[:, None] - xb[p][None, :])
                      * valid[p][None, :] for p in range(nb)]
                mean = sum(self.prec.mm(Ks[p], alpha[p]) for p in range(nb))
                W = self._forward(Ls, Ws, torch.stack([k.mT for k in Ks]))
                var = k0 - sum(torch.sum(w * w, dim=0) for w in W)
            return (mean[:, 0].cpu().numpy().astype(np.float64),
                    var.cpu().numpy().astype(np.float64))

        return predict

    # -- stochastic Lanczos quadrature --------------------------------------

    def slq_loglike_and_grad(self, theta, y, probes, num_steps):
        """The log-likelihood of ``y`` with ``log det K`` by stochastic
        Lanczos quadrature over ``probes`` ``(k, n)`` in ``num_steps``
        steps (the quadratic term exact), and its gradient: the quadratic
        term's exact, the log-determinant's the Hutchinson estimate
        ``mean_j v_j^T K^{-1} (dK/dtheta) v_j`` over the same probes.
        Returns ``(float, numpy (p,))``."""
        prep = self._prep(theta)
        b, nb, xb, valid, diag = prep
        th = self._theta(theta)
        P = np.asarray(probes, dtype=np.float64).T               # (n, k)
        with torch.no_grad():
            D, E = self._blocks(th, prep)
            Ls, Ws = self._factor(D, E)

            def solve(R):
                return torch.stack(self._backward(
                    Ls, Ws, self._forward(Ls, Ws, R)))

            Y = self._rhs(y, b, nb)
            Zy = solve(Y)
            V = self._rhs(P, b, nb)
            WV = solve(V)
            quad = torch.sum(Y * Zy)
            Ds, Es = torch.stack(D), torch.stack(E[1:])
            del Ls, Ws, D, E

            def matvec(X):                                     # (nb, b, k)
                out = self.prec.mm(Ds, X)
                out[1:] += self.prec.mm(Es, X[:-1])
                out[:-1] += self.prec.mm(Es.mT, X[1:])
                return out

            ld = self._slq(matvec, V, num_steps)
            del Ds, Es
        value = float(-0.5 * (quad + ld + self.n * LOG_2PI))
        # d/dtheta of 1/2 z^T K z - 1/2 mean_j w_j^T K v_j at fixed z, w, v
        k = V.shape[2]
        th = th.clone().requires_grad_()
        g = torch.zeros_like(th)
        for p in range(nb):
            K = self._kblock(th, xb, valid, diag, p, p)
            s = 0.5 * torch.sum(Zy[p] * (K @ Zy[p])) \
                - 0.5 / k * torch.sum(WV[p] * (K @ V[p]))
            if p:
                K = self._kblock(th, xb, valid, diag, p, p - 1)
                s = s + torch.sum(Zy[p] * (K @ Zy[p - 1])) - 0.5 / k * (
                    torch.sum(WV[p] * (K @ V[p - 1]))
                    + torch.sum(V[p] * (K @ WV[p - 1])))
            g = g + torch.autograd.grad(s, th)[0]
        return value, g.detach().cpu().numpy().astype(np.float64)

    def _slq(self, matvec, V, num_steps):
        """``n * mean_j e1^T log(T_j) e1`` over the Lanczos tridiagonals
        ``T_j`` of the probe columns of ``V`` ``(nb, b, k)``; each step
        reorthogonalizes twice against the whole basis."""
        Q = [V / torch.sqrt(torch.sum(V * V, dim=(0, 1)))]
        alphas, betas = [], []
        for j in range(num_steps):
            w = matvec(Q[j])
            alphas.append(torch.sum(w * Q[j], dim=(0, 1)))
            B = torch.stack(Q)
            for _ in range(2):
                w = w - torch.einsum(
                    "jk,jpbk->pbk",
                    torch.einsum("jpbk,pbk->jk", B, w), B)
            beta = torch.sqrt(torch.sum(w * w, dim=(0, 1)))
            betas.append(beta)
            Q.append(w / beta)
        a = torch.stack(alphas, dim=1)                           # (k, m)
        bt = torch.stack(betas, dim=1)[:, :-1]
        T = (torch.diag_embed(a) + torch.diag_embed(bt, 1)
             + torch.diag_embed(bt, -1)).to(torch.float64)
        evals, evecs = torch.linalg.eigh(T)
        evals = torch.clamp_min(evals, torch.finfo(evals.dtype).tiny)
        est = torch.sum(evecs[:, 0, :] ** 2 * torch.log(evals), dim=1)
        return self.n * torch.mean(est)
