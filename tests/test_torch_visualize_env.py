"""The port's ``utils/visualize.py`` and ``utils/env.py`` against the JAX
package's, on the CPU.

The visualize functions are numpy on both sides, so their outputs are
compared exactly on seeded inputs; ``add_image_tb`` through a stand-in
writer that records its calls. The home directories follow ``$SEG_HOME``
(a temporary directory set through ``monkeypatch``), fall back to
``~/.medicalseg_torch``, and are created at first read, never at import.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from medicalseg_tpu.utils import visualize as jvis
from medicalseg_torch import utils as tutils
from medicalseg_torch.utils import env as tenv
from medicalseg_torch.utils import visualize as tvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB_HOMES = {"DATA_HOME": "dataset", "TMP_HOME": "tmp",
             "PRETRAINED_MODEL_HOME": "pretrained_model"}


class RecordingWriter:
    """Stands in for tensorboardX's SummaryWriter: keeps each
    ``add_image`` call."""

    def __init__(self):
        self.calls = []

    def add_image(self, tag, img, step):
        self.calls.append((tag, np.array(img), step))


@pytest.mark.parametrize("num_classes", [1, 2, 7, 20, 255])
def test_color_map_list_matches_jax(num_classes):
    assert tvis.get_color_map_list(num_classes) == \
        jvis.get_color_map_list(num_classes)


@pytest.mark.parametrize("color_map", [None, "short"])
def test_pseudo_color_map_matches_jax(color_map):
    rng = np.random.RandomState(0)
    pred = rng.randint(-3, 300, (17, 23))  # past both ends of the palette
    cmap = jvis.get_color_map_list(5) if color_map else None
    got = tvis.get_pseudo_color_map(pred, cmap)
    want = jvis.get_pseudo_color_map(pred, cmap)
    assert got.dtype == np.uint8 and got.shape == (17, 23, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weight", [0.0, 0.6, 1.0])
def test_visualize_matches_jax(weight):
    rng = np.random.RandomState(1)
    image = rng.randn(19, 21).astype(np.float32) * 300.0
    pred = rng.randint(0, 4, (19, 21))
    got = tvis.visualize(image, pred, weight=weight)
    want = jvis.visualize(image, pred, weight=weight)
    assert got.dtype == np.uint8 and got.shape == (19, 21, 3)
    np.testing.assert_array_equal(got, want)


def test_add_image_tb_matches_jax():
    """The middle slice of each 3-D volume (after squeezing) as a [1, H,
    W] uint8 image under ``prefix/name``; a 2-D entry is skipped."""
    rng = np.random.RandomState(2)
    volumes = [rng.rand(1, 5, 6, 7).astype(np.float32) * 40.0 - 20.0,
               rng.randint(0, 3, (4, 8, 9)),
               rng.rand(6, 6).astype(np.float32),
               np.full((3, 4, 5), 7.0, np.float32)]  # flat: no division by 0
    names = ["image", "label", "flat2d", "constant"]
    ours, ref = RecordingWriter(), RecordingWriter()
    tvis.add_image_tb(ours, volumes, names, 12, tag_prefix="val")
    jvis.add_image_tb(ref, volumes, names, 12, tag_prefix="val")
    assert [c[0] for c in ours.calls] == ["val/image", "val/label",
                                          "val/constant"]
    assert len(ours.calls) == len(ref.calls)
    for (tag, img, step), (jtag, jimg, jstep) in zip(ours.calls, ref.calls):
        assert (tag, step) == (jtag, jstep)
        assert img.dtype == np.uint8 and img.shape[0] == 1
        np.testing.assert_array_equal(img, jimg)


def test_homes_follow_seg_home(monkeypatch, tmp_path):
    seg_home = tmp_path / "seg"
    seg_home.mkdir()
    monkeypatch.setenv("SEG_HOME", str(seg_home))
    assert tenv.SEG_HOME == tutils.SEG_HOME == str(seg_home)
    for name, sub in SUB_HOMES.items():
        assert not (seg_home / sub).exists()
        assert getattr(tenv, name) == str(seg_home / sub)
        assert (seg_home / sub).is_dir()  # created at first read
        assert getattr(tutils, name) == str(seg_home / sub)
    # a $SEG_HOME that is not a directory falls back to the user's home
    monkeypatch.setenv("SEG_HOME", str(tmp_path / "missing"))
    monkeypatch.setenv("HOME", str(tmp_path / "user"))
    assert tenv.USER_HOME == str(tmp_path / "user")
    assert tenv.SEG_HOME == str(tmp_path / "user" / ".medicalseg_torch")
    assert tenv.TMP_HOME == str(tmp_path / "user" / ".medicalseg_torch" /
                                "tmp")
    assert not (tmp_path / "missing").exists()


def test_importing_env_creates_no_directory(tmp_path):
    home = tmp_path / "home"
    home.mkdir()
    code = ("import medicalseg_torch.utils.env, medicalseg_torch.utils\n"
            "from medicalseg_torch.utils.env import USER_HOME, SEG_HOME\n"
            "print(SEG_HOME)\n")
    env = dict(os.environ, HOME=str(home))
    env.pop("SEG_HOME", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(home / ".medicalseg_torch")
    assert list(home.iterdir()) == []


def test_unknown_names_raise_attribute_error():
    with pytest.raises(AttributeError):
        tenv.NO_SUCH_HOME
    with pytest.raises(AttributeError):
        tutils.NO_SUCH_HOME
