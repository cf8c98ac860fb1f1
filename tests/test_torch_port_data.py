"""The port's datasets, EXR reader, colorize and PLY writer against the JAX
package's, on files written to tmp_path.

The Stanford, Matterport and 360D samples must equal the JAX package's bit
for bit for the same seed and split file, augmentations on and off: both
read with cv2 (the same INTER_AREA resize and BGR order), both draw their
augmentations from one numpy generator in the same order. The 360D depth
goes through each package's own native EXR reader; the port's builds under
omnifusion_torch/_build/.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

import omnifusion_tpu.data.datasets as jax_datasets
import omnifusion_tpu.utils as jax_utils
import omnifusion_torch.data.datasets as datasets
import omnifusion_torch.native as native
from omnifusion_tpu.native import read_exr_channel as jax_read_exr
from omnifusion_torch.utils import colorize, ply

cv2 = pytest.importorskip("cv2")


# -- a scanline EXR writer: a copy of tests/test_native_exr.py's ----------

def _attr(name: str, type_: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + type_.encode() + b"\0" + struct.pack("<i", len(data)) + data


def _chlist(channels, pixel_type: int) -> bytes:
    out = b""
    for name in channels:
        out += name.encode() + b"\0"
        out += struct.pack("<i", pixel_type)  # 1=HALF, 2=FLOAT
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\0"


def _zip_encode(raw: bytes) -> bytes:
    # inverse of OpenEXR's zip postprocess: interleave-split then predictor
    arr = np.frombuffer(raw, np.uint8)
    half = (len(arr) + 1) // 2
    split = np.empty_like(arr)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    enc = split.astype(np.int32)
    enc[1:] = (enc[1:] - split[:-1].astype(np.int32) + 128) % 256
    return zlib.compress(enc.astype(np.uint8).tobytes())


def write_exr(path, channel_data: dict, pixel_type: int, compression: int,
              window: bool = True, shift_last: int = 0):
    """channel_data: {name: (H, W) float array}; channels stored sorted.
    ``window=False`` leaves out the dataWindow attribute; ``shift_last``
    moves the scanline y that the last chunk states (corrupt files)."""
    names = sorted(channel_data)
    h, w = channel_data[names[0]].shape
    lines_per_block = 16 if compression == 3 else 1

    header = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    header += _attr("channels", "chlist", _chlist(names, pixel_type))
    header += _attr("compression", "compression", struct.pack("<B", compression))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    if window:
        header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    np_type = np.float16 if pixel_type == 1 else np.float32
    blocks = []
    for y0 in range(0, h, lines_per_block):
        nlines = min(lines_per_block, h - y0)
        raw = b""
        for line in range(y0, y0 + nlines):
            for name in names:
                raw += channel_data[name][line].astype(np_type).tobytes()
        payload = raw if compression == 0 else _zip_encode(raw)
        if compression != 0 and len(payload) >= len(raw):
            payload = raw  # EXR stores uncompressed if zip doesn't shrink
        y = y0 + (shift_last if y0 + lines_per_block >= h else 0)
        blocks.append(struct.pack("<ii", y, len(payload)) + payload)

    table_off = len(header) + 8 * len(blocks)
    offsets = []
    pos = table_off
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(header)
        for o in offsets:
            f.write(struct.pack("<Q", o))
        for b in blocks:
            f.write(b)


# -- datasets written to tmp_path ---------------------------------------------

def write_split(root, kind: str, n: int, hw=(512, 1024), lines=None) -> str:
    """``n`` panoramas of dataset ``kind`` under ``root`` (RGB PNGs; depth as
    a 16-bit PNG in the dataset's scale, or an EXR for 360d, some of it past
    the dataset's max depth) and a split file of their relative paths;
    returns the split file's path."""
    rng = np.random.default_rng({"stanford": 0, "matterport": 1, "360d": 2}[kind])
    rows = []
    for i in range(n):
        rgb = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        depth_m = rng.random(hw) * 11 + 0.05  # metres, past 8 and 10 m in places
        cv2.imwrite(os.path.join(root, f"{kind}{i}_rgb.png"), rgb)
        if kind == "360d":
            depth_name = f"{kind}{i}_depth.exr"
            write_exr(os.path.join(root, depth_name), {"R": depth_m.astype(np.float32)}, 2, 3)
        else:
            scale = 65535 / 128 if kind == "stanford" else 4000
            depth_name = f"{kind}{i}_depth.png"
            png = np.clip(depth_m * scale, 0, 65535).astype(np.uint16)
            cv2.imwrite(os.path.join(root, depth_name), png)
        rows.append(f"/{kind}{i}_rgb.png /{depth_name}")
    split = os.path.join(root, f"{kind}_{n}.txt")
    with open(split, "w") as f:
        f.write("\n".join(rows[:lines]) + "\n")
    return split


KINDS = {"stanford": ((256, 512), (512, 1024)), "matterport": ((256, 512), (512, 1024)),
         "360d": ((256, 512), (256, 512))}  # (file size, pano size); 360D's EXR is not resized
AUGMENT = {"none": {}, "flip_rotate": dict(flip=True, rotate=True),
           "every_augmentation": dict(flip=True, rotate=True, permute_color=True, gamma=True)}


@pytest.mark.parametrize("augment", sorted(AUGMENT))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_samples_equal_jax_bit_for_bit(tmp_path, kind, augment):
    file_hw, pano_hw = KINDS[kind]
    split = write_split(str(tmp_path), kind, 3, file_hw)
    ours = datasets.make_dataset(kind, str(tmp_path), split, seed=5, **AUGMENT[augment])
    theirs = jax_datasets.make_dataset(kind, str(tmp_path), split, seed=5, **AUGMENT[augment])
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):  # the generators stay in step from sample to sample
        for i in (0, 2, 1):
            for a, b, name in zip(ours[i], theirs[i], ("rgb", "depth", "mask")):
                assert a.dtype == b.dtype == np.float32, name
                assert a.shape == b.shape == (*pano_hw, 3 if name == "rgb" else 1), name
                np.testing.assert_array_equal(a, b, err_msg=f"{kind} {i} {name} epoch {epoch}")
    rgb, depth, mask = ours[0]
    assert 0 < mask.mean() < 1 and (depth[mask == 0] == 0).all()
    assert depth.max() <= ours.max_depth


def test_one_line_split_file(tmp_path):
    split = write_split(str(tmp_path), "stanford", 2, (64, 128), lines=1)
    ours = datasets.StanfordDataset(str(tmp_path), split)
    assert ours.image_list.ndim == 2 and len(ours) == 1
    np.testing.assert_array_equal(
        ours[0][1], jax_datasets.StanfordDataset(str(tmp_path), split)[0][1])


def test_make_dataset_dispatch():
    assert isinstance(datasets.make_dataset("synthetic", size=2), datasets.SyntheticDataset)
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.make_dataset("semantic")


@pytest.mark.parametrize("compression", [0, 2, 3], ids=["none", "zips", "zip"])
@pytest.mark.parametrize("pixel_type", [1, 2], ids=["half", "float"])
def test_exr_reader_equals_jax(tmp_path, compression, pixel_type):
    rng = np.random.default_rng(compression * 10 + pixel_type)
    data = {c: (rng.random((37, 53)) * 8).astype(np.float32) for c in "BGR"}
    path = str(tmp_path / "t.exr")
    write_exr(path, data, pixel_type, compression)
    for c in "RG":
        got = native.read_exr_channel(path, c)
        np.testing.assert_array_equal(got, jax_read_exr(path, c))
        want = data[c].astype(np.float16).astype(np.float32) if pixel_type == 1 else data[c]
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="channel not found"):
        native.read_exr_channel(path, "Z")
    # the port builds its own library, under its _build directory
    lib = native.build()
    assert os.path.dirname(lib) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(os.path.dirname(os.path.dirname(native.__file__)),
                                            "_build")


# the last chunk's y: last line 36 (NONE), last block at 32 (ZIP); h = 37
@pytest.mark.parametrize("compression, shift", [(0, -37), (0, 1), (3, -48), (3, 16), (3, 1)],
                         ids=["none_before", "none_past", "zip_before", "zip_past",
                              "zip_off_block"])
def test_exr_reader_refuses_chunks_outside_the_window(tmp_path, compression, shift):
    """A chunk whose scanline lies before the data window, past its end or
    off a block boundary is refused before anything is written."""
    path = str(tmp_path / "t.exr")
    write_exr(path, {"R": np.ones((37, 53), np.float32)}, 2, compression, shift_last=shift)
    with pytest.raises(RuntimeError, match="corrupt chunk"):
        native.read_exr_channel(path, "R")
    # read_exr_r names the native reader's failure (cv2 here cannot decode
    # the file: it is corrupt, or cv2 lacks OpenEXR) and chains it
    with pytest.raises(RuntimeError, match="native reader failed.*corrupt chunk") as e:
        datasets.read_exr_r(path)
    assert isinstance(e.value.__cause__, RuntimeError)


def test_exr_reader_refuses_a_header_without_data_window(tmp_path):
    path = str(tmp_path / "t.exr")
    write_exr(path, {"R": np.ones((4, 5), np.float32)}, 2, 0, window=False)
    with pytest.raises(RuntimeError, match="no data window"):
        native.read_exr_channel(path, "R")


class _Cv2Stub:
    """cv2 as read_exr_r calls it, built with OpenEXR: imread gives ``img``."""
    IMREAD_UNCHANGED = -1
    error = type("error", (Exception,), {})

    def __init__(self, img):
        self.img, self.calls = img, []

    def imread(self, path, flags):
        self.calls.append((path, flags))
        return self.img


@pytest.mark.parametrize("shape", [(6, 7, 3), (6, 7)], ids=["bgr", "one_channel"])
def test_read_exr_r_falls_back_to_cv2(tmp_path, monkeypatch, shape):
    """A compression the native reader refuses (PIZ) goes through cv2, as in
    the JAX package: channel 0 of what cv2.imread gives, as float32."""
    path = str(tmp_path / "piz.exr")
    write_exr(path, {"R": np.ones((6, 7), np.float32)}, 2, 4)
    with pytest.raises(RuntimeError, match="unsupported compression"):
        native.read_exr_channel(path, "R")
    img = np.random.default_rng(6).random(shape).astype(np.float64)
    stub = _Cv2Stub(img)
    monkeypatch.setitem(sys.modules, "cv2", stub)
    got = datasets.read_exr_r(path)
    assert got.dtype == np.float32 and stub.calls == [(path, -1)]
    np.testing.assert_array_equal(got, (img[..., 0] if img.ndim == 3 else img).astype(np.float32))
    np.testing.assert_array_equal(got, jax_datasets.read_exr_r(path))


def test_read_exr_r_without_cv2_names_the_native_failure(tmp_path, monkeypatch):
    path = str(tmp_path / "piz.exr")
    write_exr(path, {"R": np.ones((6, 7), np.float32)}, 2, 4)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    with pytest.raises(RuntimeError, match="unsupported compression.*cv2 is not importable"):
        datasets.read_exr_r(path)


@pytest.mark.parametrize("vmin", [None, 0.0])
def test_colorize_equals_jax(vmin):
    value = np.random.default_rng(3).random((8, 16, 1)).astype(np.float32) * 5
    for v in (value, np.zeros((4, 4))):  # and the vmin == vmax path
        np.testing.assert_array_equal(colorize(v, vmin=vmin), jax_utils.colorize(v, vmin=vmin))


def test_ply_and_pointcloud_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    depth = (rng.random((16, 32, 1)) * 7 + 0.2).astype(np.float32)
    rgb = rng.random((16, 32, 3)).astype(np.float32)
    xyz, colors = ply.depth_to_pointcloud(depth, rgb)
    jxyz, jcolors = jax_utils.ply.depth_to_pointcloud(depth, rgb)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(colors, jcolors)
    np.testing.assert_array_equal(ply.depth_to_pointcloud(depth), xyz)
    fields = ["x", "y", "z", "red", "green", "blue"]
    ply.write_ply(str(tmp_path / "ours"), [xyz, colors], fields)
    jax_utils.ply.write_ply(str(tmp_path / "theirs.ply"), [xyz, colors], fields)
    assert (tmp_path / "ours.ply").read_bytes() == (tmp_path / "theirs.ply").read_bytes()
    back = ply.read_ply(str(tmp_path / "theirs.ply"))
    np.testing.assert_array_equal(back, jax_utils.ply.read_ply(str(tmp_path / "ours.ply")))
    np.testing.assert_array_equal(np.stack([back[c] for c in "xyz"], -1), xyz)
