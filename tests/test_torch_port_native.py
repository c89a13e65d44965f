"""The port's native host library (``afigan_tpu_torch/native``) against the JAX
package's (``afigan_tpu/native``), and the port's RLE codec
(``afigan_tpu_torch/evaluation/rle.py``) against JAX's
(``afigan_tpu/evaluation/rle.py``) with the native path on and off.

* Each of the six C entries equals JAX's on seeded masks (empty, full, one
  pixel, 1xN, Nx1, 0/255, a first pixel in the foreground, bool), counts
  whose deltas go negative, varints of 13 and more characters, and crowd and
  non-crowd IoU. The box IoU is compared at 1e-12 relative: JAX builds with
  ``-march=native``, which lets g++ contract ``da + ga - iw * ih`` into a
  fused multiply-add.
* The codec: every function equal to JAX's, native on and off (off: the
  loader forced to None). The cases with the loader off run everywhere; the
  ones that need ``g++`` skip where it is absent.
* First use: eight threads at once get one library from one build; two
  processes into an empty build directory both load a whole file; without
  ``g++`` on PATH ``require_lib()`` raises and ``get_lib()`` returns None
  (logged once) and the codec takes its numpy path.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

import afigan_tpu.native as jax_native
from afigan_tpu.evaluation import rle as jax_rle
import afigan_tpu_torch.native as native
from afigan_tpu_torch.evaluation import rle
from tests.torch_port_common import REPO


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")


@pytest.fixture
def both_native(gxx):
    """Both packages' libraries loaded (skips where JAX's cannot be built)."""
    native.require_lib()
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library cannot be built here")


def _masks():
    rng = np.random.RandomState(0)
    one = np.zeros((6, 5), np.uint8)
    one[3, 2] = 1
    first = (rng.rand(9, 7) > 0.5).astype(np.uint8)
    first[0, 0] = 1
    return {
        "empty": np.zeros((7, 5), np.uint8),
        "full": np.ones((7, 5), np.uint8),
        "one_pixel": one,
        "1xN": (rng.rand(1, 13) > 0.5).astype(np.uint8),
        "Nx1": (rng.rand(13, 1) > 0.5).astype(np.uint8),
        "0_255": ((rng.rand(11, 8) > 0.4) * 255).astype(np.uint8),
        "first_foreground": first,
        "random": (rng.rand(31, 17) > 0.5).astype(np.uint8),
        "bool": rng.rand(12, 10) > 0.7,
        "blob": np.pad(np.ones((20, 30), np.uint8), ((10, 14), (6, 9))),
    }


MASKS = _masks()
# deltas against count[i-2] go negative (3 - 5, 7 - 100); 2**62 and its
# neighbours take 13-character varints, the negative deltas too
COUNTS = {
    "short": [12],
    "empty": [],
    "negative_deltas": [0, 5, 100, 3, 250, 7, 1, 2],
    "large": [100000, 1, 99999, 2],
    "varint_13": [2 ** 62, 1, 2 ** 62 - 5, 3, 7, 2 ** 62],
    "varint_13_negative": [5, 2 ** 62, 9, 1],
}
# a varint of 14 characters (bits past the 64th dropped by both libraries),
# and one cut off by its last continuation bit (both return -1)
STRINGS = {"varint_14": "o" * 13 + "0" + "1", "truncated": "12P"}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_encode_decode_equal_jax(both_native, name):
    m = MASKS[name]
    got = native.native_encode_counts(m)
    assert got == jax_native.native_encode_counts(m)
    with _loader_off():
        assert got == rle.mask_to_rle_counts(m)  # the numpy path
    h, w = m.shape
    back = native.native_decode(got, h, w)
    np.testing.assert_array_equal(back, jax_native.native_decode(got, h, w))
    np.testing.assert_array_equal(back, (m != 0).astype(np.uint8))


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_string_equal_jax(both_native, name):
    counts = COUNTS[name]
    s = native.native_counts_to_string(counts)
    assert s == jax_native.native_counts_to_string(counts)
    assert native.native_string_to_counts(s) == jax_native.native_string_to_counts(s) == counts
    if name.startswith("varint_13"):
        assert max(len(v) for v in _varints(s)) >= 13


@pytest.mark.parametrize("name", sorted(STRINGS))
def test_string_to_counts_edge_cases_equal_jax(both_native, name):
    s = STRINGS[name]
    got = native.native_string_to_counts(s)
    assert got == jax_native.native_string_to_counts(s)
    assert (got is None) == (name == "truncated")


def _varints(s):
    out, cur = [], ""
    for ch in s:
        cur += ch
        if not (ord(ch) - 48) & 0x20:
            out.append(cur)
            cur = ""
    return out


@pytest.mark.parametrize("iscrowd", [False, True])
def test_iou_equal_jax(both_native, iscrowd):
    rng = np.random.RandomState(2)
    m1 = (rng.rand(40, 30) > 0.5).astype(np.uint8)
    m2 = (rng.rand(40, 30) > 0.5).astype(np.uint8)
    a, b = native.native_encode_counts(m1), native.native_encode_counts(m2)
    got = native.native_rle_iou(a, b, iscrowd)
    assert got == jax_native.native_rle_iou(a, b, iscrowd)
    inter = np.logical_and(m1, m2).sum()
    union = m1.sum() if iscrowd else np.logical_or(m1, m2).sum()
    np.testing.assert_allclose(got, inter / union, rtol=1e-12)
    e = native.native_encode_counts(np.zeros((40, 30), np.uint8))
    assert native.native_rle_iou(e, e, iscrowd) == jax_native.native_rle_iou(e, e, iscrowd) == 0.0

    dt = np.concatenate([rng.rand(7, 2) * 50, rng.rand(7, 2) * 30 + 1], axis=1)
    gt = np.concatenate([rng.rand(5, 2) * 50, rng.rand(5, 2) * 30 + 1], axis=1)
    gt[2] = dt[4]  # an exact match
    crowd = np.array([0, 1, 0, 0, 1], np.uint8) if iscrowd else np.zeros(5, np.uint8)
    got = native.native_bbox_iou(dt, gt, crowd)
    np.testing.assert_allclose(got, jax_native.native_bbox_iou(dt, gt, crowd), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(got[4, 2], 1.0, rtol=1e-12)


def test_iou_of_an_empty_counts_list_raises_as_numpy(gxx):
    native.require_lib()
    with pytest.raises(IndexError):
        native.native_rle_iou([], [4, 2], False)
    with _loader_off(), pytest.raises(IndexError):
        rle.rle_iou({"counts": [], "size": [2, 3]}, {"counts": [4, 2], "size": [2, 3]})


@contextlib.contextmanager
def _loader_off():
    """Both packages' loaders return None: the numpy paths run."""
    saved = native.get_lib, jax_native.get_lib
    native.get_lib = jax_native.get_lib = lambda: None
    try:
        yield
    finally:
        native.get_lib, jax_native.get_lib = saved


def _codec_cases():
    rng = np.random.RandomState(3)
    m1 = (rng.rand(24, 18) > 0.6).astype(np.uint8)
    m2 = (rng.rand(24, 18) > 0.6).astype(np.uint8)
    return m1, m2


@pytest.mark.parametrize("path", ["numpy", "native"])
def test_codec_equal_jax(path, request):
    if path == "native":
        request.getfixturevalue("both_native")
    with _loader_off() if path == "numpy" else contextlib.nullcontext():
        before = dict(native.CALLS)
        for name, m in MASKS.items():
            want = jax_rle.mask_to_rle_counts(m)
            assert rle.mask_to_rle_counts(m) == want, name
            h, w = m.shape
            np.testing.assert_array_equal(rle.rle_counts_to_mask(want, h, w),
                                          jax_rle.rle_counts_to_mask(want, h, w))
            enc = rle.encode_mask(m)
            assert enc == jax_rle.encode_mask(m), name
            np.testing.assert_array_equal(rle.decode_rle(enc), jax_rle.decode_rle(enc))
            assert rle.rle_area(enc) == jax_rle.rle_area(enc) == int((m != 0).sum())
        for name, counts in COUNTS.items():
            s = rle.counts_to_string(counts)
            assert s == jax_rle.counts_to_string(counts), name
            assert rle.string_to_counts(s) == jax_rle.string_to_counts(s) == counts
        m1, m2 = _codec_cases()
        a, b = rle.encode_mask(m1), rle.encode_mask(m2)
        for crowd in (False, True):
            assert rle.rle_iou(a, b, crowd) == jax_rle.rle_iou(a, b, crowd)
    used = {k: native.CALLS[k] - before[k] for k in native.CALLS}
    if path == "numpy":
        assert not any(used.values()), used
    else:
        assert used["rle_encode"] > 0 and used["rle_counts_to_string"] > 0
        assert used["rle_string_to_counts"] > 0 and used["rle_iou_single"] == 2


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """An empty build directory and a loader that has not tried yet."""
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    return tmp_path / "native"


def test_threads_reach_first_use_together(gxx, fresh, monkeypatch):
    runs = []
    real_run = subprocess.run

    def counted(*a, **k):
        runs.append(a[0])
        return real_run(*a, **k)

    monkeypatch.setattr(native.subprocess, "run", counted)
    n = 8
    barrier = threading.Barrier(n)
    got = [None] * n

    def first_use(i):
        barrier.wait(timeout=60)
        got[i] = (native.get_lib(), native.native_encode_counts(MASKS["random"]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1
    libs = {id(lib) for lib, _ in got}
    assert len(libs) == 1 and got[0][0] is not None
    assert all(c == got[0][1] for _, c in got)
    assert sorted(p.name for p in fresh.iterdir()) == [native.lib_path().name]


def test_processes_reach_first_use_together(gxx, tmp_path):
    out = tmp_path / "native"
    code = ("import sys, json\nfrom pathlib import Path\nimport numpy as np\n"
            "import afigan_tpu_torch.native as n\n"
            "n.build_dir = lambda: Path(sys.argv[1])\n"
            "lib = n.require_lib()\n"
            "print(json.dumps([str(n.lib_path()), n.native_encode_counts(np.eye(5))]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    assert results[0] == results[1]
    assert results[0][1] == rle.mask_to_rle_counts(np.eye(5))
    assert [p.name for p in out.iterdir()] == [os.path.basename(results[0][0])]


def test_no_compiler(fresh, monkeypatch, tmp_path, caplog):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.require_lib()
    with caplog.at_level("WARNING", logger=native.__name__):
        assert native.get_lib() is None
        assert native.get_lib() is None
        assert native.native_encode_counts(MASKS["random"]) is None
    assert len([r for r in caplog.records if "numpy codec" in r.getMessage()]) == 1
    assert rle.encode_mask(MASKS["random"]) == jax_rle.encode_mask(MASKS["random"])
    assert not fresh.exists() or not any(fresh.iterdir())
