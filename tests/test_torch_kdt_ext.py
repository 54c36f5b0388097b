"""The port's build of native/kdt_ext.c (kubedtn_tpu_torch.native
.kdt_ext): `slice_frames` equals the pure-Python materialization, and
JAX's FrameSeg, on the same blobs; the build lands ABI-tagged in the
port's _build/ and loads from there, never as kubedtn_tpu.kdt_ext; where
the Python headers do not resolve the Python path stays (the plane's
health says so), and where they resolve a failed build raises."""

import sysconfig

import numpy as np
import pytest

import kubedtn_tpu.wire.server as jsrv
import kubedtn_tpu_torch.native as tnat
import kubedtn_tpu_torch.wire.server as tsrv

import test_torch_plane as tp


def blob_segment(seed, n=300):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 200, n).astype(np.uint64)
    offs = np.zeros(n, np.uint64)
    np.cumsum(lens[:-1], out=offs[1:])
    blob = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8).tobytes()
    perm = rng.permutation(n)  # offsets need not be sorted
    return blob, offs[perm].copy(), lens[perm].copy()


def python_path(blob, offs, lens, lo, hi):
    return [blob[o:o + n] for o, n in zip(offs[lo:hi].tolist(),
                                          lens[lo:hi].tolist())]


@pytest.fixture
def ext():
    mod = tnat.kdt_ext()
    if mod is None:
        pytest.skip(f"kdt_ext not built here: {tnat.kdt_ext_reason()}")
    return mod


@pytest.mark.parametrize("lo,hi", [(0, 300), (17, 211), (40, 40),
                                   (299, 300)])
def test_slice_frames_equals_the_python_path(ext, lo, hi):
    blob, offs, lens = blob_segment(lo + hi)
    want = python_path(blob, offs, lens, lo, hi)
    assert ext.slice_frames(blob, offs, lens, lo, hi) == want
    seg = tsrv.FrameSeg(blob, offs, lens, lo, hi)
    assert seg.materialize() == want
    assert jsrv.FrameSeg(blob, offs, lens, lo, hi).materialize() == want


def test_slice_frames_rejects_windows_outside_the_arrays(ext):
    blob, offs, lens = blob_segment(3, n=10)
    with pytest.raises(ValueError, match="window"):
        ext.slice_frames(blob, offs, lens, 5, 11)
    bad = lens.copy()
    bad[0] = np.uint64(len(blob) + 1)
    with pytest.raises(ValueError, match="blob"):
        ext.slice_frames(blob, offs, bad, 0, 1)


def test_build_is_abi_tagged_in_the_ports_build_dir(ext):
    path = tnat.kdt_ext_path()
    assert path.exists() and path.parent == tnat.BUILD_DIR
    assert path.name.endswith(sysconfig.get_config_var("EXT_SUFFIX"))
    assert ext.__file__ == str(path)
    assert ext.__name__ == "kdt_ext"


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """Headers resolve, the source does not compile: NativeUnavailable,
    never a silent fallback."""
    bad = tmp_path / "kdt_ext.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(tnat, "EXT_SOURCE", bad)
    monkeypatch.setattr(tnat, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnat, "_ext_state", (False, None, None))
    monkeypatch.setattr(tnat, "python_include",
                        lambda: (str(tmp_path), True))
    with pytest.raises(tnat.NativeUnavailable, match="kdt_ext build failed"):
        tnat.kdt_ext()
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_no_headers_keeps_the_python_path(monkeypatch, caplog):
    """Python.h does not resolve: kdt_ext() is None with the reason kept
    and logged once, materialize runs in Python, the plane reports
    kdt_ext false."""
    monkeypatch.setattr(tnat, "_ext_state", (False, None, None))
    monkeypatch.setattr(tnat, "python_include",
                        lambda: ("/nonexistent/include", False))
    with caplog.at_level("WARNING"):
        assert tnat.kdt_ext() is None
        assert tnat.kdt_ext() is None
    assert caplog.text.count("kdt_ext not built") == 1
    assert "Python.h not found" in tnat.kdt_ext_reason()
    blob, offs, lens = blob_segment(9)
    assert tsrv.FrameSeg(blob, offs, lens, 3, 90).materialize() == \
        python_path(blob, offs, lens, 3, 90)
    sc = tp.build("torch", [])
    assert sc.plane.health()["kdt_ext"] is False


def test_plane_reports_kdt_ext(ext):
    assert tp.build("torch", []).plane.health()["kdt_ext"] is True
