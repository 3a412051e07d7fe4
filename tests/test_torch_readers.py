"""The port's file formats and dataset readers against the JAX package's.

* PNG codec (`data/png.py`, stdlib zlib and numpy) against PIL: each of
  the five filter types written and read, 8-bit gray/RGB/RGBA and 16-bit
  gray; PIL's own files read; refusals (interlaced, palette, JPEG).
* frame_utils: every reader on files written as the datasets store them,
  equal to the JAX package's readers.
* The five evaluation readers (SceneFlow's FlyingThings3D test split,
  Sintel, Dynamic Replica, Infinigen, KITTI depth) on miniature trees
  written the way tests/test_dataset_readers.py writes them: the port's
  samples must equal the JAX reader's, exactly.
* `load_yaml`'s YAML subset against yaml.safe_load on every preset.
"""

import gzip
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from ppmstereo_tpu.data import datasets as jds
from ppmstereo_tpu.data import frame_utils as jfu
from ppmstereo_tpu_torch.data import datasets as tds
from ppmstereo_tpu_torch.data import frame_utils as tfu
from ppmstereo_tpu_torch.data.png import FILTERS, read_png, write_png
from ppmstereo_tpu_torch.utils import config as tconfig

REPO = Path(__file__).resolve().parent.parent
H, W = 24, 32


# ------------------------------------------------------------------ PNG
def _image(kind: str, rng, h=13, w=21):
    if kind == "gray16":
        return rng.integers(0, 65536, (h, w)).astype(np.uint16)
    shape = {"gray": (h, w), "rgb": (h, w, 3), "rgba": (h, w, 4)}[kind]
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("filter_type", FILTERS)
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16"])
def test_png_writes_what_pil_reads_and_reads_it_back(tmp_path, kind, filter_type):
    rng = np.random.default_rng(filter_type)
    img = _image(kind, rng)
    path = str(tmp_path / "x.png")
    write_png(path, img, filter_type)
    raw = open(path, "rb").read()
    # every row carries the filter type it was written with
    assert zlib.decompress(raw[raw.index(b"IDAT") + 4:])[0] == filter_type
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    got = read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16"])
def test_png_reads_pil_files(tmp_path, kind):
    """PIL picks a filter per row: noise and a smooth ramp give it different
    choices."""
    rng = np.random.default_rng(7)
    h, w = 40, 50
    channels = {"gray": 1, "rgb": 3, "rgba": 4, "gray16": 1}[kind]
    ramp = np.add.outer(np.arange(h) * 3, np.arange(w) * 5)
    smooth = np.stack([ramp * (c + 1) for c in range(channels)], -1)
    smooth = smooth[..., 0] if channels == 1 else smooth
    path = str(tmp_path / "pil.png")
    for img in (_image(kind, rng, h, w), smooth):
        if kind == "gray16":
            img = (img.astype(np.int64) * 97 % 65536).astype(np.uint16)
            Image.frombytes("I;16", (w, h), img.astype("<u2").tobytes()).save(path)
        else:
            img = (img.astype(np.int64) % 256).astype(np.uint8)
            Image.fromarray(img).save(path)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        np.testing.assert_array_equal(read_png(path), img)


def _chunks(blob: bytes):
    pos, out = 8, []
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        out.append((blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def _rewrite_ihdr(src: str, dst: str, **fields) -> None:
    blob = open(src, "rb").read()
    out = blob[:8]
    for kind, body in _chunks(blob):
        if kind == b"IHDR":
            w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            vals = dict(depth=depth, colour=colour, interlace=interlace)
            vals.update(fields)
            body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["colour"], comp, filt,
                               vals["interlace"])
        out += struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    open(dst, "wb").write(out)


def test_png_refuses_what_it_does_not_read(tmp_path):
    rng = np.random.default_rng(0)
    plain = str(tmp_path / "plain.png")
    write_png(plain, _image("rgb", rng))
    interlaced = str(tmp_path / "interlaced.png")
    _rewrite_ihdr(plain, interlaced, interlace=1)
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        read_png(interlaced)
    palette = str(tmp_path / "palette.png")
    Image.fromarray(_image("rgb", rng)).convert("P").save(palette)
    with pytest.raises(ValueError, match="palette.png: PNG of colour type 3"):
        read_png(palette)
    rgb16 = str(tmp_path / "rgb16.png")
    _rewrite_ihdr(plain, rgb16, depth=16)
    with pytest.raises(ValueError, match="rgb16.png: PNG of colour type 2 and bit depth 16"):
        read_png(rgb16)
    corrupt = str(tmp_path / "corrupt.png")
    blob = bytearray(open(plain, "rb").read())
    blob[-20] ^= 0xFF
    open(corrupt, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="corrupt.png: bad CRC"):
        read_png(corrupt)
    jpeg = str(tmp_path / "frame.jpg")
    Image.fromarray(_image("rgb", rng)).save(jpeg)
    with pytest.raises(ValueError, match="frame.jpg.*PNG"):
        tfu.read_image(jpeg)
    with pytest.raises(ValueError, match="frame.jpg"):
        tfu.read_gen(jpeg)
    with pytest.raises(ValueError, match="not a PNG file"):
        read_png(jpeg)
    with pytest.raises(ValueError, match="filter type 5"):
        write_png(plain, _image("rgb", rng), 5)


# ----------------------------------------------------------- frame_utils
def test_frame_readers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    # .flo
    flo = str(tmp_path / "a.flo")
    flow = rng.normal(size=(H, W, 2)).astype(np.float32)
    with open(flo, "wb") as f:
        np.array([jfu.FLO_MAGIC], np.float32).tofile(f)
        np.array([W, H], np.int32).tofile(f)
        flow.tofile(f)
    np.testing.assert_array_equal(tfu.read_flow(flo), jfu.read_flow(flo))
    np.testing.assert_array_equal(tfu.read_gen(flo), flow)
    # PFM, gray and colour, written by either package
    for shape in ((H, W), (H, W, 3)):
        data = rng.normal(size=shape).astype(np.float32)
        for writer, name in ((tfu.write_pfm, "t.pfm"), (jfu.write_pfm, "j.pfm")):
            path = str(tmp_path / name)
            writer(path, data)
            np.testing.assert_array_equal(tfu.read_pfm(path), data)
            np.testing.assert_array_equal(tfu.read_pfm(path), jfu.read_pfm(path))
            want = data if data.ndim == 2 else data[..., :-1]
            np.testing.assert_array_equal(tfu.read_gen(path), want)
    assert open(str(tmp_path / "t.pfm"), "rb").read() == open(str(tmp_path / "j.pfm"),
                                                               "rb").read()
    # images: RGB, RGBA and gray PNGs written by PIL
    for arr in (_image("rgb", rng, H, W), _image("rgba", rng, H, W), _image("gray", rng, H, W)):
        path = str(tmp_path / "img.png")
        Image.fromarray(arr).save(path)
        got = tfu.read_image(path)
        assert got.shape == (H, W, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jfu.read_image(path))
        np.testing.assert_array_equal(tfu.read_gen(path), jfu.read_gen(path))
    # Sintel packed disparity with its occlusion map
    os.makedirs(tmp_path / "disparities" / "s")
    os.makedirs(tmp_path / "occlusions" / "s")
    disp_png = str(tmp_path / "disparities" / "s" / "frame_0001.png")
    Image.fromarray(_image("rgb", rng, H, W)).save(disp_png)
    Image.fromarray((rng.random((H, W)) < 0.2).astype(np.uint8) * 255).save(
        disp_png.replace("disparities", "occlusions"))
    for got, want in zip(tfu.read_disp_sintel(disp_png), jfu.read_disp_sintel(disp_png)):
        np.testing.assert_array_equal(got, want)
    # Middlebury ground truth with its non-occlusion mask
    gt = str(tmp_path / "disp0GT.pfm")
    jfu.write_pfm(gt, rng.uniform(0, 60, (H, W)).astype(np.float32))
    Image.fromarray((rng.random((H, W)) < 0.7).astype(np.uint8) * 255).save(
        str(tmp_path / "mask0nocc.png"))
    for got, want in zip(tfu.read_disp_middlebury(gt), jfu.read_disp_middlebury(gt)):
        np.testing.assert_array_equal(got, want)
    # depth: float16 bits in a 16-bit PNG, KITTI and VKITTI2 16-bit PNGs
    f16 = rng.uniform(0.5, 20, (H, W)).astype(np.float16)
    depth16 = str(tmp_path / "depth.png")
    Image.frombytes("I;16", (W, H), f16.view(np.uint16).astype("<u2").tobytes()).save(depth16)
    np.testing.assert_array_equal(tfu.read_16bit_float_depth(depth16),
                                  jfu.read_16bit_float_depth(depth16))
    np.testing.assert_array_equal(tfu.read_depth_any(depth16), f16.astype(np.float32))
    for sub in ("kitti_depth", "vkitti2"):
        os.makedirs(tmp_path / sub)
        raw = rng.integers(0, 30000, (H, W)).astype(np.uint16)
        raw[0, :5] = 0
        path = str(tmp_path / sub / "d.png")
        Image.frombytes("I;16", (W, H), raw.astype("<u2").tobytes()).save(path)
        np.testing.assert_array_equal(tfu.read_depth_any(path), jfu.read_depth_any(path))
    npy = str(tmp_path / "d.npy")
    np.save(npy, rng.random((H, W)).astype(np.float32))
    np.testing.assert_array_equal(tfu.read_depth_any(npy), jfu.read_depth_any(npy))


# --------------------------------------------------------------- readers
def _rgb(path, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(path)


def _f16_depth(path, depth):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    u16 = np.asarray(depth, np.float16).view(np.uint16)
    Image.frombytes("I;16", (W, H), u16.astype("<u2").tobytes()).save(path)


def _assert_samples_equal(port, ref):
    assert len(port) == len(ref) > 0
    assert list(port.extra_info) == list(ref.extra_info)
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"sample {i} {key}")


def test_dynamic_replica_matches_jax(tmp_path):
    root = tmp_path / "dr"
    rng = np.random.default_rng(2)
    for split in ("valid", "train"):
        annots = []
        for seq, n in (("seqA", 5), ("seqB", 19)):
            for cam in ("left", "right"):
                for i in range(n):
                    img_rel = f"{seq}/images/{cam}_{i:03d}.png"
                    depth_rel = f"{seq}/depths/{cam}_{i:03d}.png"
                    _rgb(str(root / split / img_rel), seed=i)
                    depth = rng.uniform(0.5, 30, (H, W))
                    depth[0, :3] = 0.0  # no depth: invalid
                    _f16_depth(str(root / split / depth_rel), depth)
                    annots.append({
                        "sequence_name": seq, "camera_name": cam,
                        "image": {"path": img_rel, "size": [H, W]},
                        "depth": {"path": depth_rel},
                        "viewpoint": {"focal_length": [2.0, 2.0], "principal_point": [0, 0],
                                      "intrinsics_format": ("ndc_norm_image_bounds"
                                                            if seq == "seqA" else "ndc_isotropic"),
                                      "T": [0.0, 0, 0] if cam == "left" else [0.5, 0, 0]},
                    })
        with gzip.open(root / split / f"frame_annotations_{split}.jgz", "wt",
                       encoding="utf8") as f:
            json.dump(annots, f)
    for kwargs in (dict(split="valid", sample_len=2), dict(split="valid", sample_len=2,
                                                           only_first_n_samples=2),
                   dict(split="valid", sample_len=-1), dict(split="train", sample_len=3)):
        port = tds.DynamicReplicaDataset(root=str(root), **kwargs)
        ref = jds.DynamicReplicaDataset(root=str(root), **kwargs)
        _assert_samples_equal(port, ref)
        assert [s["depth2disp_scale"] for s in port.sample_list] == \
            [s["depth2disp_scale"] for s in ref.sample_list]
    assert len(tds.DynamicReplicaDataset(root=str(root), split="valid", sample_len=2,
                                         only_first_n_samples=2)) == 4


@pytest.mark.parametrize("things_test", [True, False])
def test_sceneflow_matches_jax(tmp_path, things_test):
    """FlyingThings3D's TEST and TRAIN splits, Monkaa and Driving: PNG
    frames, PFM disparity (some of it past 512: invalid), each clip also
    time-reversed."""
    root = tmp_path / "SceneFlow"
    rng = np.random.default_rng(3)
    seqs = [f"FlyingThings3D/frames_finalpass/{split}/A/{seq}" for split in ("TEST", "TRAIN")
            for seq in ("0000", "0001")]
    seqs += ["Monkaa/frames_finalpass/a_rain", "Driving/frames_finalpass/15mm/fwd/fast"]
    for seq in seqs:
        for cam in ("left", "right"):
            for i in range(4):
                _rgb(str(root / seq / cam / f"{i:04d}.png"), seed=i)
                pfm = root / seq.replace("frames_finalpass", "disparity") / cam / f"{i:04d}.pfm"
                os.makedirs(pfm.parent, exist_ok=True)
                jfu.write_pfm(str(pfm), rng.uniform(1, 600, (H, W)).astype(np.float32))
    port = tds.SequenceSceneFlowDataset(root=str(root), sample_len=2, things_test=things_test)
    ref = jds.SequenceSceneFlowDataset(root=str(root), sample_len=2, things_test=things_test)
    # 2 clips of each 4-frame sequence, forward and reversed: the TEST split's
    # 2 sequences, or Monkaa's and Driving's (the 2 TRAIN sequences fall in
    # the 40 the permutation keeps for TEST, as every sequence of a small
    # split does)
    assert len(port) == 8
    _assert_samples_equal(port, ref)


def test_sintel_matches_jax(tmp_path):
    root = tmp_path / "sintel"
    rng = np.random.default_rng(4)
    for seq in ("alley_1", "bamboo_2"):
        for i in range(1, 4):
            frame = f"frame_{i:04d}.png"
            for d in ("clean_left", "clean_right"):
                _rgb(str(root / "training" / d / seq / frame), seed=i)
            os.makedirs(root / "training/disparities" / seq, exist_ok=True)
            os.makedirs(root / "training/occlusions" / seq, exist_ok=True)
            Image.fromarray(rng.integers(0, 40, (H, W, 3), dtype=np.uint8)).save(
                str(root / "training/disparities" / seq / frame))
            Image.fromarray((rng.random((H, W)) < 0.2).astype(np.uint8) * 255).save(
                str(root / "training/occlusions" / seq / frame))
    port = tds.SequenceSintelStereo(dstype="clean", root=str(root))
    ref = jds.SequenceSintelStereo(dstype="clean", root=str(root))
    _assert_samples_equal(port, ref)
    assert port.sparse and port.extra_info == ["alley_1", "bamboo_2"]


def test_infinigen_matches_jax(tmp_path):
    root = tmp_path / "infinigen"
    rng = np.random.default_rng(5)
    for scene, with_cam in (("scene0", True), ("scene1", False)):
        base = root / scene / "frames"
        for i in range(3):
            _rgb(str(base / "Image/camera_0" / f"{i:04d}.png"), seed=i)
            _rgb(str(base / "Image/camera_1" / f"{i:04d}.png"), seed=i + 10)
            os.makedirs(base / "Depth/camera_0", exist_ok=True)
            np.save(str(base / "Depth/camera_0" / f"{i:04d}.npy"),
                    rng.uniform(0.5, 10, (H, W)).astype(np.float32))
        if with_cam:
            os.makedirs(base / "camview/camera_0", exist_ok=True)
            np.savez(str(base / "camview/camera_0/0000.npz"),
                     K=np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]]), baseline=0.1)
    for sample_len in (2, -1):
        port = tds.InfinigenStereoVideoDataset(root=str(root), sample_len=sample_len)
        ref = jds.InfinigenStereoVideoDataset(root=str(root), sample_len=sample_len)
        _assert_samples_equal(port, ref)


def test_kitti_depth_matches_jax(tmp_path):
    root = tmp_path / "kitti_depth"
    rng = np.random.default_rng(6)
    drive = "2011_09_26_drive_0001_sync"
    for i in (5, 6, 7):
        frame = f"{i:010d}.png"
        raw = rng.integers(300, 20000, (H, W)).astype(np.uint16)
        raw[rng.random((H, W)) < 0.7] = 0  # sparse LiDAR
        path = root / "val" / drive / "proj_depth/groundtruth/image_02" / frame
        os.makedirs(path.parent, exist_ok=True)
        Image.frombytes("I;16", (W, H), raw.astype("<u2").tobytes()).save(str(path))
        if i != 7:  # a frame without images is skipped
            for cam in ("image_02", "image_03"):
                _rgb(str(root / "raw/2011_09_26" / drive / cam / "data" / frame), seed=i)
    port = tds.KITTIDepthDataset(root=str(root), split="val")
    ref = jds.KITTIDepthDataset(root=str(root), split="val")
    _assert_samples_equal(port, ref)
    assert port.sparse and len(port[0]["img"]) == 2


# ------------------------------------------------------------------ YAML
PRESETS = sorted((REPO / "ppmstereo_tpu_torch" / "configs").glob("*.yaml"))


def test_the_port_has_every_preset():
    assert [p.name for p in PRESETS] == sorted(
        p.name for p in (REPO / "ppmstereo_tpu" / "configs").glob("*.yaml"))


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p.stem)
def test_load_yaml_reads_the_presets_as_yaml_does(preset):
    from ppmstereo_tpu_torch.cli.evaluate import DefaultConfig

    text = preset.read_text()
    data = tconfig.parse_yaml(text, str(preset))
    assert data == yaml.safe_load(text)
    twin = REPO / "ppmstereo_tpu" / "configs" / preset.name
    assert data == yaml.safe_load(twin.read_text())  # the same settings as the JAX preset
    cfg = tconfig.load_yaml(DefaultConfig, str(preset), overrides=["MODEL.iters=3", "crop=2"])
    assert cfg.MODEL.iters == 3 and cfg.crop == 2
    assert cfg.MODEL.kernel_size == data["MODEL"]["kernel_size"]
    assert tconfig.to_dict(cfg)["MODEL"]["model_name"] == data["MODEL"]["model_name"]


def test_load_yaml_subset_and_refusals():
    text = ("# c\na: 1\nb: 1.5\nc: yes\nd: 'x y'\ne: \"q\"\nf: null\ng: ~\nh: -3\ni: .5\n"
            "j: 1.0e+3\nk: 1e5\nl: ./x/y # trailing\nm:\n  n: 2\n  o:\n    p: off\n"
            "q: 0\nr: .inf\nt: 3_000\nv: 'a#b'\nw:\n")
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)
    for bad, what in (("a: [1, 2]", ":1:"), ("a:\n  - 1", ":2:"), ("a: {b: 1}", ":1:"),
                      ("a: &x 1", ":1:"), ("a: 0x1f", ":1:"), ("a: 1\n  b: 2", ":2:"),
                      ("a: |\n  x", ":1:"), ("a: 1\na: 2", ":2:"), ("a:\n\tb: 1", ":2:")):
        with pytest.raises(ValueError, match=f"<yaml>{what}"):
            tconfig.parse_yaml(bad)
