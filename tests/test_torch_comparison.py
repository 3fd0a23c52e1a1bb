"""The comparison GIF tool (``tools/comparison.py``) with its GIF writer
(``utils/gif.py``) and PIL's BICUBIC resize (``core/resize.py``), held
against PIL 12.1 and the JAX tool on the CPU."""
import cv2
import numpy as np
import pytest
from PIL import Image

from opticalflowcontainer_tpu.tools import comparison as jcomparison
from opticalflowcontainer_tpu_torch.core.resize import resize_bicubic_pil
from opticalflowcontainer_tpu_torch.tools import comparison
from opticalflowcontainer_tpu_torch.utils import gif


def smooth(H, W, seed, cell=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (H // cell + 3, W // cell + 3, 3)).astype(np.float32)
    return np.clip(cv2.resize(x, (W, H), interpolation=cv2.INTER_CUBIC),
                   0, 255).astype(np.uint8)


def pil_frames(path) -> tuple[Image.Image, list[np.ndarray]]:
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
    return im, frames


@pytest.mark.parametrize("src,dst", [
    ((37, 51), (61, 23)), ((48, 64), (48, 97)), ((101, 13), (7, 13)),
    ((5, 5), (1, 1)), ((1, 1), (9, 4)), ((120, 160), (60, 80)),
    ((33, 47), (66, 94))], ids=str)
@pytest.mark.parametrize("channels", [1, 3])
def test_bicubic_equals_pil_bit_for_bit(src, dst, channels):
    rng = np.random.default_rng(src[0] * dst[1])
    img = rng.integers(0, 256, src + ((channels,) if channels > 1 else ()), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BICUBIC))
    got = resize_bicubic_pil(img, dst)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_pil_reads_the_gif_as_written(tmp_path):
    """Two frames, 500 ms each, looping forever; each frame PIL decodes is
    the port's palette-indexed frame through its palette, exactly."""
    frames = [smooth(96, 128, 1), smooth(96, 128, 2)]
    palette, indexed = gif.quantize(frames)
    path = str(tmp_path / "c.gif")
    gif.write_gif(path, palette, indexed, duration_ms=500, loop=0)
    im, decoded = pil_frames(path)
    assert (im.n_frames, im.info["duration"], im.info["loop"]) == (2, 500, 0)
    assert len(palette) == 256
    for got, idx in zip(decoded, indexed):
        np.testing.assert_array_equal(got, palette[idx])


def test_palette_colours_against_the_inputs_and_pil(tmp_path):
    """On smooth colour frames the median-cut palette's mean absolute error
    per channel is at most PIL's own adaptive palette's on the same frames
    (measured: the port's 10.5 against PIL's 11.3 on an 8-pixel grid);
    frames of at most 256 colours come back exactly."""
    frames = [smooth(96, 128, 3, cell=8), smooth(96, 128, 4, cell=8)]
    palette, indexed = gif.quantize(frames)
    ours = np.mean([np.abs(palette[i].astype(int) - f).mean()
                    for i, f in zip(indexed, frames)])
    a, b = (Image.fromarray(f) for f in frames)
    a.save(tmp_path / "p.gif", save_all=True, append_images=[b], duration=500,
           loop=0)
    _, pil = pil_frames(tmp_path / "p.gif")
    theirs = np.mean([np.abs(p.astype(int) - f).mean() for p, f in zip(pil, frames)])
    assert ours <= theirs, (ours, theirs)
    gray = [np.repeat(f[..., :1], 3, axis=-1) for f in frames]
    palette, indexed = gif.quantize(gray)
    for idx, f in zip(indexed, gray):
        np.testing.assert_array_equal(palette[idx], f)


@pytest.mark.parametrize("n", [1, 4096, 128 * 130])
def test_lzw_past_the_full_table(tmp_path, n):
    """Noise fills the 4096-entry table (clear codes mid-stream); PIL
    decodes every index exactly."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, 256, (1, n), np.uint8)
    palette = rng.integers(0, 256, (256, 3), np.uint8)
    path = str(tmp_path / "n.gif")
    gif.write_gif(path, palette, [idx, idx[:, ::-1].copy()], duration_ms=40)
    _, decoded = pil_frames(path)
    np.testing.assert_array_equal(decoded[0], palette[idx])
    np.testing.assert_array_equal(decoded[1], palette[idx[:, ::-1]])


def test_tool_against_the_jax_tool(tmp_path, capsys):
    """A PNG and a JPEG of another size: the port's GIF has the JAX tool's
    frame count, size, duration and loop; its second frame is the JPEG
    (decoded as cv2 decodes it) resized as PIL resizes it, then put
    through the palette."""
    one, two = str(tmp_path / "one.png"), str(tmp_path / "two.jpg")
    a, b = smooth(90, 120, 5), smooth(61, 83, 6)
    cv2.imwrite(one, a)
    cv2.imwrite(two, b)
    out, jout = str(tmp_path / "c.gif"), str(tmp_path / "j.gif")
    assert comparison.main([one, two, "--out", out, "--duration-ms", "300",
                            "--force-python"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    assert jcomparison.main([one, two, "--out", jout, "--duration-ms", "300"]) == 0
    im, decoded = pil_frames(out)
    jim, _ = pil_frames(jout)
    assert (im.n_frames, im.size, im.info["duration"], im.info["loop"]) == (
        jim.n_frames, jim.size, jim.info["duration"], jim.info["loop"])
    rgb_b = cv2.imread(two)[..., ::-1]
    want_b = np.asarray(Image.fromarray(rgb_b).resize((120, 90), Image.BICUBIC))
    palette, indexed = gif.quantize([a[..., ::-1], want_b])
    for got, idx in zip(decoded, indexed):
        np.testing.assert_array_equal(got, palette[idx])
    with pytest.raises(SystemExit, match="cannot read"):
        comparison.main([one, __file__, "--out", out, "--force-python"])
