"""PyTorch port, command line: `python -m roibasedimagecompression_torch`
against the JAX package's CLI on the same synthetic PNGs, on the CPU
(`--device cpu`).  Encoded bytes and decoded PNGs are equal; eval / sweep /
compare print the same JSON and text but for the float32 metrics, which sum
in another order (PSNR, MSE, MAE within 1e-6 relative, SSIM within 2e-6);
a bad command and a missing file give the same exit codes."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from roibasedimagecompression_tpu import __main__ as JCLI
from roibasedimagecompression_torch import __main__ as TCLI
from roibasedimagecompression_torch.io import image_io
from roibasedimagecompression_torch.utils.synthetic import synthetic_image

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """Runs each test's torch work on one thread and restores the count
    after: the suite runs several worker processes on the host's cores, and
    a torch thread pool per worker only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def slic_pallas_mode(monkeypatch):
    """The port follows the JAX SLIC's Pallas mode; its bytes are compared
    with the JAX package run in that mode."""
    monkeypatch.setenv("RHCCQ_SLIC_PALLAS", "1")
    jax.clear_caches()
    yield
    monkeypatch.delenv("RHCCQ_SLIC_PALLAS")
    jax.clear_caches()


def _png(folder, seed, h=128, w=160, name=None, dark=False):
    img = synthetic_image(seed, h, w)
    if dark:  # shadows for the enhancer
        img = (img * 0.45).astype(np.uint8)
    path = folder / (name or f"img{seed}.png")
    image_io.imwrite(path, img)
    return path


def _run(cli, argv, capsys):
    rc = cli.main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _close(ours, theirs, path=""):
    """JSON values equal: strings and integers exactly, floats within 1e-6
    relative (float32 means in another order: an ulp or two; a standard
    deviation over them within 1e-5), SSIM-derived ones within 2e-6."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _close(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(theirs, float):
        tol = dict(rel=1e-6, abs=1e-6)
        if "ssim" in path:
            tol = dict(abs=2e-6)
        elif path.endswith("_std"):
            tol = dict(abs=1e-5)
        assert ours == pytest.approx(theirs, **tol), path
    else:
        assert ours == theirs, path


ENCODE_ARGS = {
    "default": [],
    "mediancut": ["--split-method", "mediancut"],
    "kmeans-mc": ["--split-method", "kmeans-mc"],
    "enhance-shadows": ["--enhance-shadows"],
    "single-region": ["--single-region"],
    "container-level-7": ["--container-level", "7"],
    "palette-refine-2": ["--palette-refine", "2"],
}


@pytest.mark.parametrize("case", list(ENCODE_ARGS))
def test_cli_encode_matches_jax(slic_pallas_mode, tmp_path, capsys, case):
    seed = {"enhance-shadows": 62}.get(case, 61)
    png = _png(tmp_path, seed, dark=case == "enhance-shadows")
    extra = ENCODE_ARGS[case]
    rc_j, out_j, _ = _run(JCLI, ["encode", png, tmp_path / "j.rhccq", *extra], capsys)
    rc_t, out_t, _ = _run(TCLI, ["encode", png, tmp_path / "t.rhccq", *extra, "--device", "cpu"], capsys)
    assert rc_j is None and rc_t is None
    ours, theirs = (tmp_path / "t.rhccq").read_bytes(), (tmp_path / "j.rhccq").read_bytes()
    assert ours == theirs
    # The printed line is the same but for the seconds and MP/s.
    assert out_t.split(" in ")[0] == out_j.split(" in ")[0].replace("j.rhccq", "t.rhccq")


def _encoded_pair(tmp_path, seed=63):
    png = _png(tmp_path, seed)
    rq = tmp_path / "x.rhccq"
    assert TCLI.main(["encode", str(png), str(rq), "--device", "cpu"]) is None
    return png, rq


def test_cli_decode_matches_jax(tmp_path, capsys):
    png, rq = _encoded_pair(tmp_path)
    capsys.readouterr()
    assert _run(JCLI, ["decode", rq, tmp_path / "j.png"], capsys)[:2] == (None, f"{tmp_path / 'j.png'}: 160x128\n")
    assert _run(TCLI, ["decode", rq, tmp_path / "t.png"], capsys)[:2] == (None, f"{tmp_path / 't.png'}: 160x128\n")
    np.testing.assert_array_equal(image_io.imread_rgb(tmp_path / "t.png"), image_io.imread_rgb(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


@pytest.mark.parametrize("adaptive", [False, True])
def test_cli_eval_matches_jax(tmp_path, capsys, adaptive):
    png, rq = _encoded_pair(tmp_path)
    capsys.readouterr()
    flag = ["--adaptive"] if adaptive else []
    rc_j, out_j, err_j = _run(JCLI, ["eval", png, rq, *flag], capsys)
    rc_t, out_t, err_t = _run(TCLI, ["eval", png, rq, *flag, "--device", "cpu"], capsys)
    assert rc_j is None and rc_t is None
    _close(json.loads(out_t), json.loads(out_j))
    assert json.loads(out_t)["psnr"] > 28.0
    if adaptive:  # the report on stderr; its SSIM lines print 4 decimals
        assert err_t.splitlines()[:-4] == err_j.splitlines()[:-4]


def test_cli_sweep_and_compare_match_jax(tmp_path, capsys):
    root = tmp_path / "images"
    (root / "png").mkdir(parents=True)
    (root / "rhccq_20_10").mkdir()
    for i, seed in ((1, 64), (2, 65)):
        png = _png(root / "png", seed, name=f"{i}.png")
        assert TCLI.main(["encode", str(png), str(root / "rhccq_20_10" / f"compressed_{i}.rhccq"),
                          "--device", "cpu"]) is None
    capsys.readouterr()
    rc_j, out_j, _ = _run(JCLI, ["sweep", root, "--csv", tmp_path / "j.csv"], capsys)
    rc_t, out_t, _ = _run(TCLI, ["sweep", root, "--csv", tmp_path / "t.csv", "--device", "cpu"], capsys)
    assert rc_j is None and rc_t is None
    assert out_t.splitlines()[:3] == out_j.splitlines()[:3]
    assert out_t.splitlines()[-2:] == out_j.splitlines()[-2:]
    rows_t = (tmp_path / "t.csv").read_text().splitlines()
    rows_j = (tmp_path / "j.csv").read_text().splitlines()
    assert len(rows_t) == len(rows_j) == 3 and rows_t[0] == rows_j[0]

    png, rq = root / "png" / "1.png", root / "rhccq_20_10" / "compressed_1.rhccq"
    rc_j, out_j, _ = _run(JCLI, ["compare", png, rq, "--html", tmp_path / "j.html"], capsys)
    rc_t, out_t, _ = _run(TCLI, ["compare", png, rq, "--html", tmp_path / "t.html", "--device", "cpu"], capsys)
    assert rc_j is None and rc_t is None
    j_json, t_json = out_j[: out_j.rindex("}") + 1], out_t[: out_t.rindex("}") + 1]
    _close(json.loads(t_json), json.loads(j_json))
    assert (tmp_path / "t.html").read_text().count("<tr>") == 2


def test_cli_exit_codes_match_jax(tmp_path, capsys):
    for cli in (JCLI, TCLI):
        with pytest.raises(SystemExit) as exc:
            cli.main(["transcode", "a", "b"])
        assert exc.value.code == 2
    missing = [tmp_path / "none.png", tmp_path / "none.rhccq"]
    assert _run(JCLI, ["eval", *missing], capsys)[0] == 2
    rc, _, err = _run(TCLI, ["eval", *missing, "--device", "cpu"], capsys)
    assert rc == 2 and err.startswith("error: ")
    assert _run(JCLI, ["decode", missing[1], tmp_path / "o.png"], capsys)[0] == 2
    assert _run(TCLI, ["decode", missing[1], tmp_path / "o.png"], capsys)[0] == 2


def test_python_m_imports_no_jax(tmp_path):
    """`python -m roibasedimagecompression_torch encode ... --device cpu` in a
    fresh interpreter writes the CPU bytes and never imports jax or the JAX
    package (read from the interpreter's own import log)."""
    png = _png(tmp_path, 66)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "roibasedimagecompression_torch", "encode",
         str(png), str(tmp_path / "m.rhccq"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    imported = {line.split("|")[-1].strip() for line in out.stderr.splitlines() if "|" in line}
    assert "roibasedimagecompression_torch.models.codec" in imported
    bad = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "roibasedimagecompression_tpu"))
    assert bad == []
    assert TCLI.main(["encode", str(png), str(tmp_path / "p.rhccq"), "--device", "cpu"]) is None
    assert (tmp_path / "m.rhccq").read_bytes() == (tmp_path / "p.rhccq").read_bytes()


@pytest.mark.cuda
def test_cli_encode_on_the_card_equals_cpu(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    png = _png(tmp_path, 67, 256, 320)
    assert TCLI.main(["encode", str(png), str(tmp_path / "g.rhccq")]) is None
    assert TCLI.main(["encode", str(png), str(tmp_path / "c.rhccq"), "--device", "cpu"]) is None
    assert (tmp_path / "g.rhccq").read_bytes() == (tmp_path / "c.rhccq").read_bytes()
