"""Vision kernel tests: Harris detect, window gathers, descriptors, matcher.

Strategy per SURVEY.md §6: NumPy oracles for the response math, the window
gathers and the matcher, plus behavioral tests (known corners detected,
shifted images re-matched).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ptzjax import match as matchlib
from ptzjax.kernels import descriptor as desclib
from ptzjax.kernels import detect as detlib
from ptzjax.kernels import flow as flowlib
from ptzjax.kernels.descriptor import describe_keypoints
from ptzjax.kernels.detect import detect_keypoints, harris_response
from tests.oracle.harris_np import harris_np, nms3_np


def _texture(h=96, w=160, seed=0):
    """Smooth random texture: generic corners everywhere."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(h // 8 + 1, w // 8 + 1))
    img = np.kron(base, np.ones((8, 8)))[:h, :w]
    # light smoothing so gradients are informative
    from tests.oracle.harris_np import smooth5_np

    return smooth5_np(smooth5_np(img)).astype(np.float32)


def _corner_image(h=128, w=192):
    """Bright axis-aligned squares -> corners at known positions."""
    img = np.zeros((h, w), np.float32)
    corners = []
    for cy in range(24, h - 24, 32):
        for cx in range(24, w - 24, 32):
            img[cy : cy + 9, cx : cx + 9] = 1.0
            corners.append((cx, cy))  # top-left corner of each square
    return img, np.array(corners, np.float32)


class TestHarris:
    def test_response_matches_numpy_oracle(self):
        img = _texture()
        got = np.asarray(harris_response(jnp.asarray(img)))
        want = harris_np(img)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)

    @pytest.mark.parametrize("seed", [3, 11])
    def test_nms_keep_set_matches_numpy_oracle(self, seed):
        """Harris + 3x3 NMS keeps exactly the pixels the NumPy oracle keeps
        (strict max over the top-left neighbours, >= over the rest)."""
        img = _texture(h=100, w=200, seed=seed)
        sup = np.asarray(detlib._nms3(harris_response(jnp.asarray(img))))
        want = nms3_np(harris_np(img).astype(np.float32))
        np.testing.assert_array_equal(sup > -1e29, want > -1e29)

    def test_detect_finds_known_corners(self):
        img, corners = _corner_image()
        kp = detect_keypoints(jnp.asarray(img), max_keypoints=64)
        xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
        assert len(xy) >= len(corners)  # each square has 4 corners
        # every marked square corner should have a detection within 1.5 px
        for cx, cy in corners:
            d = np.hypot(xy[:, 0] - (cx - 0.5), xy[:, 1] - (cy - 0.5))
            assert d.min() < 1.5, (cx, cy, d.min())

    def test_mask_suppresses_detections(self):
        img, _ = _corner_image()
        mask = np.ones(img.shape, bool)
        mask[:, : img.shape[1] // 2] = False  # forbid left half
        kp = detect_keypoints(jnp.asarray(img), 64, mask=jnp.asarray(mask))
        xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
        assert (xy[:, 0] >= img.shape[1] // 2 - 1).all()


def _blend_np(win_img, fy, fx, win):
    return (
        win_img[:win, :win] * (1 - fy) * (1 - fx)
        + win_img[:win, 1 : win + 1] * (1 - fy) * fx
        + win_img[1 : win + 1, :win] * fy * (1 - fx)
        + win_img[1 : win + 1, 1 : win + 1] * fy * fx
    )


class TestWindowGather:
    @pytest.mark.parametrize("win", [desclib.PATCH + 2, desclib.SCALED_WIN])
    def test_extract_aligned_matches_numpy(self, win):
        """Descriptor windows (both the fixed and the zoom-normalized size)
        equal NumPy slicing of the edge-padded image plus the bilinear
        blend, for subpixel keypoints and keypoints on the border."""
        img = _texture(h=120, w=200, seed=7)
        rng = np.random.default_rng(7)
        xy = np.stack(
            [rng.uniform(1.0, 199.0, 37), rng.uniform(1.0, 119.0, 37)], -1
        ).astype(np.float32)
        xy[0] = [0.2, 0.3]          # extreme corner
        xy[1] = [198.9, 118.7]
        xy[2] = [-3.0, 60.0]        # outside: window clamps to the pad
        got = np.asarray(
            desclib._extract_aligned(jnp.asarray(img), jnp.asarray(xy), win)
        )
        h, w = img.shape
        half, pad = win // 2, win // 2 + 1
        pimg = np.pad(img, pad, mode="edge")
        for k, (x, y) in enumerate(xy):
            y0, x0 = int(np.floor(y + 0.5)), int(np.floor(x + 0.5))
            fy = np.clip(y + 0.5 - y0, 0.0, 1.0)
            fx = np.clip(x + 0.5 - x0, 0.0, 1.0)
            ys = np.clip(y0 - half + pad, 0, h + 2 * pad - win - 1)
            xs = np.clip(x0 - half + pad, 0, w + 2 * pad - win - 1)
            patch = pimg[ys : ys + win + 1, xs : xs + win + 1]
            np.testing.assert_allclose(
                got[k], _blend_np(patch, fy, fx, win), rtol=1e-6, atol=1e-6
            )

    @pytest.mark.parametrize("size", [14, 25])
    def test_flow_gather_matches_numpy_slicing(self, size):
        """LK's integer window gather is exact slicing, including windows
        that start on the first and end on the last row/column."""
        rng = np.random.default_rng(3)
        img = rng.normal(size=(77, 183)).astype(np.float32)
        ys = rng.integers(0, 77 - size + 1, 21).astype(np.int32)
        xs = rng.integers(0, 183 - size + 1, 21).astype(np.int32)
        ys[:2] = [0, 77 - size]
        xs[:2] = [183 - size, 0]
        out = np.asarray(
            flowlib._gather(
                jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs), size
            )
        )
        assert out.shape == (21, size, size)
        for k in range(21):
            np.testing.assert_array_equal(
                out[k], img[ys[k] : ys[k] + size, xs[k] : xs[k] + size]
            )


class TestDescriptor:
    def test_unit_norm_and_masking(self):
        img = _texture(seed=1)
        xy = jnp.asarray([[40.0, 30.0], [80.0, 50.0], [0.0, 0.0]])
        valid = jnp.asarray([True, True, False])
        d = describe_keypoints(jnp.asarray(img), xy, valid)
        n = np.linalg.norm(np.asarray(d), axis=-1)
        np.testing.assert_allclose(n[:2], 1.0, atol=1e-5)
        assert n[2] == 0.0

    def test_translation_equivariance(self):
        """Descriptor at (x, y) of img == descriptor at (x+5, y+3) of the
        shifted image — the property tracking actually relies on."""
        img = _texture(h=120, w=160, seed=2)
        sh = np.zeros_like(img)
        sh[3:, 5:] = img[:-3, :-5]
        pts = np.array([[60.0, 40.0], [90.0, 70.0], [40.0, 80.0]], np.float32)
        v = jnp.ones((3,), bool)
        d0 = describe_keypoints(jnp.asarray(img), jnp.asarray(pts), v)
        d1 = describe_keypoints(
            jnp.asarray(sh), jnp.asarray(pts + np.array([5.0, 3.0])), v
        )
        cos = np.sum(np.asarray(d0) * np.asarray(d1), -1)
        assert (cos > 0.999).all(), cos

    def test_distinct_patches_distinct_descriptors(self):
        img = _texture(h=120, w=160, seed=4)
        pts = np.stack(
            np.meshgrid(np.arange(30, 130, 20), np.arange(30, 90, 20)), -1
        ).reshape(-1, 2).astype(np.float32)
        v = jnp.ones((len(pts),), bool)
        d = np.asarray(describe_keypoints(jnp.asarray(img), jnp.asarray(pts), v))
        s = d @ d.T
        off = s - np.diag(np.diag(s))
        assert off.max() < 0.98  # no two distinct patches collapse


def _match_np(dq, dr, qv, rv, ratio, mutual, min_score, gate=None):
    """Brute-force NumPy matcher: the semantics ptzjax.match implements,
    one query row at a time (fp64 scores)."""
    s = dq.astype(np.float64) @ dr.astype(np.float64).T
    allowed = qv[:, None] & rv[None, :]
    if gate is not None:
        allowed &= gate
    s = np.where(allowed, s, -np.inf)
    q = s.shape[0]
    idx = np.zeros(q, np.int64)
    ok = np.zeros(q, bool)
    for i in range(q):
        row = s[i]
        if not qv[i] or not np.isfinite(row).any():
            continue
        order = np.argsort(-row, kind="stable")
        b, v1 = order[0], row[order[0]]
        v2 = row[order[1]] if len(order) > 1 else -np.inf
        good = v1 > min_score
        if np.isfinite(v2):  # the ratio test needs a second candidate
            good &= max(1.0 - v1, 0.0) < ratio * ratio * max(1.0 - v2, 1e-12)
        if mutual:
            good &= int(np.argmax(s[:, b])) == i
        ok[i], idx[i] = good, b if good else 0
    return idx, ok


def _match_data(q=70, r=150, dim=64, seed=0):
    rng = np.random.default_rng(seed)
    dr = rng.normal(size=(r, dim)).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=-1, keepdims=True)
    perm = rng.permutation(r)[:q]
    dq = dr[perm] + 0.1 * rng.normal(size=(q, dim)).astype(np.float32)
    dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
    qv = rng.random(q) > 0.1
    rv = rng.random(r) > 0.1
    return dq, dr, qv, rv, perm


class TestMatch:
    @pytest.mark.parametrize(
        "ratio,mutual,seed", [(0.8, True, 0), (0.9, False, 1), (0.6, True, 4)]
    )
    def test_match_descriptors_matches_numpy_oracle(self, ratio, mutual, seed):
        dq, dr, qv, rv, _ = _match_data(seed=seed)
        got = matchlib.match_descriptors(
            jnp.asarray(dq), jnp.asarray(dr), jnp.asarray(qv),
            jnp.asarray(rv), ratio=ratio, mutual=mutual,
        )
        idx, ok = _match_np(dq, dr, qv, rv, ratio, mutual, 0.5)
        np.testing.assert_array_equal(np.asarray(got.ok), ok)
        np.testing.assert_array_equal(np.asarray(got.idx), idx)

    @pytest.mark.parametrize("gate_px", [10.0, 30.0])
    def test_match_gated_matches_numpy_oracle(self, gate_px):
        dq, dr, qv, rv, perm = _match_data(seed=2)
        rng = np.random.default_rng(3)
        xr = rng.uniform(0, 500, (dr.shape[0], 2)).astype(np.float32)
        xq = xr[perm] + rng.normal(0, 5, (dq.shape[0], 2)).astype(np.float32)
        got = matchlib.match_gated(
            jnp.asarray(dq), jnp.asarray(xq), jnp.asarray(dr),
            jnp.asarray(xr), jnp.asarray(qv), jnp.asarray(rv),
            gate_px=gate_px, ratio=0.9,
        )
        d2 = ((xq[:, None, :] - xr[None, :, :]) ** 2).sum(-1)
        idx, ok = _match_np(
            dq, dr, qv, rv, 0.9, True, 0.5, gate=d2 <= gate_px**2
        )
        np.testing.assert_array_equal(np.asarray(got.ok), ok)
        np.testing.assert_array_equal(np.asarray(got.idx), idx)

    def test_recovers_planted_correspondence(self):
        dq, dr, qv, rv, perm = _match_data(q=50, r=120, seed=5)
        got = matchlib.match_descriptors(
            jnp.asarray(dq), jnp.asarray(dr), jnp.asarray(qv),
            jnp.asarray(rv), ratio=0.85,
        )
        ok = np.asarray(got.ok)
        idx = np.asarray(got.idx)
        hits = (idx[ok] == perm[ok]).mean()
        assert ok.sum() > 20 and hits > 0.95


class TestEndToEndFeatures:
    def test_detect_describe_match_across_shift(self):
        """Full vision pipeline: detect+describe two shifted frames, match,
        check the recovered displacement."""
        img0 = _texture(h=144, w=240, seed=9)
        img1 = np.zeros_like(img0)
        img1[:, 7:] = img0[:, :-7]  # shift right by 7 px
        kp0 = detect_keypoints(jnp.asarray(img0), 96)
        kp1 = detect_keypoints(jnp.asarray(img1), 96)
        d0 = describe_keypoints(jnp.asarray(img0), kp0.xy, kp0.valid)
        d1 = describe_keypoints(jnp.asarray(img1), kp1.xy, kp1.valid)
        m = matchlib.match_descriptors(d1, d0, kp1.valid, kp0.valid, ratio=0.8)
        ok = np.asarray(m.ok)
        assert ok.sum() >= 20, ok.sum()
        dx = np.asarray(kp1.xy)[ok, 0] - np.asarray(kp0.xy)[np.asarray(m.idx)[ok], 0]
        dy = np.asarray(kp1.xy)[ok, 1] - np.asarray(kp0.xy)[np.asarray(m.idx)[ok], 1]
        assert abs(np.median(dx) - 7.0) < 0.3, np.median(dx)
        assert abs(np.median(dy)) < 0.3, np.median(dy)


class TestCholeskySolve:
    def test_inv_lower_neumann_exact(self):
        """_inv_lower (production: ekf.update's solve) inverts lower-
        triangular factors to fp32 substitution accuracy, across the base
        Neumann-product case and the blocked recursion (> 128)."""
        from ptzjax.ekf import _inv_lower

        rng = np.random.default_rng(1)
        for n in (16, 48, 128, 192, 256):
            a = rng.normal(size=(n, n)).astype(np.float32)
            s = a @ a.T + n * np.eye(n, dtype=np.float32)
            l = np.linalg.cholesky(s).astype(np.float32)
            il = np.asarray(_inv_lower(jnp.asarray(l)))
            err = np.abs(il @ l - np.eye(n)).max()
            assert err < 5e-5, (n, err)
            # strictly triangular: no garbage above the diagonal
            assert np.abs(np.triu(il, 1)).max() == 0.0, n

    def test_inv_chol_blocked_matches_dense(self):
        """_inv_chol (production: ekf.update's solve) must equal
        inv(cholesky(S)) to fp32 accuracy across the leaf case and the
        2x2 block recursion (192/256/512), including an ill-conditioned
        S at post-reloc scales."""
        from ptzjax.ekf import _inv_chol

        rng = np.random.default_rng(3)
        for n, spread in ((128, 2), (192, 3), (256, 4), (512, 6)):
            eigs = np.logspace(0, spread, n)
            q, _ = np.linalg.qr(rng.normal(size=(n, n)))
            s = ((q * eigs) @ q.T).astype(np.float32)
            s = 0.5 * (s + s.T)
            il = np.asarray(_inv_chol(jnp.asarray(s)))
            # il is L^{-1}: il @ L == I and il.T @ il == S^{-1}
            l = np.linalg.cholesky(s.astype(np.float64))
            err = np.abs(il @ l - np.eye(n)).max()
            assert err < 5e-4 * 10 ** (spread / 3), (n, err)
            sinv = np.linalg.inv(s.astype(np.float64))
            rel = np.abs(il.T @ il - sinv).max() / np.abs(sinv).max()
            # explicit-inverse forward error scales with cond(S) = 10^spread
            # (fp32 eps ~1e-7); the EKF's real S measures cond ~3e3
            assert rel < 100.0 * 1e-7 * 10**spread, (n, rel)
            # strictly lower triangular
            assert np.abs(np.triu(il, 1)).max() == 0.0, n

    def test_inv_lower_ill_conditioned_gain(self):
        """_inv_lower's explicit inverse has forward error
        growing with cond(L), unlike backward-stable substitution. Post-
        init/reloc S = H P H^T + R is ill-conditioned (large ray/velocity
        covariance on some slots, sigma_obs^2 floor on others). Build S
        with eigenvalue spread ~1e6 at post-reloc scales and assert the
        Kalman gain K = PHT S^-1 from the Neumann path stays close to an
        fp64 substitution solve."""
        from scipy.linalg import cho_factor, cho_solve

        from ptzjax.ekf import _inv_lower

        rng = np.random.default_rng(7)
        for n in (64, 256):
            # eigenvalues spanning sigma_obs^2 ~ 1 up to f^2 * ray_var ~ 1e6
            # (post-reloc: init_ray_std ~1e-2 rad seen through f~1100 px,
            # plus near-floor slots) — cond(S) ~ 1e6, cond(L) ~ 1e3.
            eigs = np.logspace(0, 6, n)
            q, _ = np.linalg.qr(rng.normal(size=(n, n)))
            s64 = (q * eigs) @ q.T
            s64 = 0.5 * (s64 + s64.T)
            s32 = s64.astype(np.float32)
            pht = rng.normal(size=(n + 6, n)).astype(np.float32) * np.sqrt(
                eigs
            ).astype(np.float32)

            l32 = np.linalg.cholesky(s32)
            il = np.asarray(_inv_lower(jnp.asarray(l32)))
            k_neumann = (pht @ il.T.astype(np.float32)) @ il.astype(np.float32)

            k_ref = cho_solve(
                cho_factor(s64, lower=True), pht.astype(np.float64).T
            ).T
            scale = np.abs(k_ref).max()
            rel = np.abs(k_neumann - k_ref).max() / max(scale, 1e-30)
            # fp32 + cond(L)~1e3: allow ~1e-3 relative — the Joseph-form
            # update tolerates gain error at this level (it preserves
            # covariance symmetry/PSD for ANY K)
            assert rel < 2e-3, (n, rel)
