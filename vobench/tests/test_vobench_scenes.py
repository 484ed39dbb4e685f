"""The benchmark's renderer and drive."""

import numpy as np
import pytest
import torch

from vobench import scenes


def plane_scene(tex):
    from viso_tpu_torch.data import synthetic

    planes = [synthetic.Plane(np.array(p0), np.array(n), np.array(e1), np.array(e2), tx,
                              tex_scale=40.0)
              for (p0, n, e1, e2), tx in zip(scenes.CORRIDOR, tex.numpy())]
    return synthetic.PlaneScene(planes=planes, background=scenes.BACKGROUND)


def test_render_matches_plane_scene():
    """The same rays, planes and bilinear samples as the port's host
    renderer, wherever the texture coordinates lie inside the texture
    (`PlaneScene` wraps with scipy's "wrap", whose period is one pixel
    short of the texture's size; the benchmark's textures wrap at exactly
    their size)."""
    from viso_tpu_torch.geometry import camera

    tex = scenes.textures(3, 3, 1024, "cpu")
    intr = (60.0, 60.0, 40.0, 24.0)
    R = scenes.yaw_matrix(0.02).T
    t = -R @ np.array([0.3, 0.0, 0.1])
    ref, depth = plane_scene(tex).render(camera.Intrinsics.create(*intr), R, t, 48, 80)
    got = scenes.render(scenes.CORRIDOR, tex, 40.0, intr, R, t, 48, 80).numpy()
    near = depth < 12.0   # 12 m along z: texture coordinates < 1024 - 40 * 0.6
    assert near.sum() > 0.5 * near.size
    np.testing.assert_allclose(got[near], ref[near], atol=1e-3)
    assert np.array_equal(np.isinf(depth), got == scenes.BACKGROUND)


def test_texture_wraps_at_its_size():
    tex = scenes.textures(5, 1, 64, "cpu")[0]
    v = torch.tensor([3.25, 3.25 + 64, 3.25 - 128], dtype=torch.float64)
    u = torch.tensor([10.5, 10.5 - 64, 10.5 + 192], dtype=torch.float64)
    s = scenes.sample_wrap(tex, v, u)
    assert torch.equal(s, s[:1].expand(3))


@pytest.mark.parametrize("step, period", [(0.8, 160), (0.15, 512)])
def test_sequence_is_periodic(step, period):
    """Frame P is frame 0, bit for bit, and the ground truth goes on."""
    drive = scenes.Drive(step, period, 1.0, 1024, 40.0)
    tex = scenes.textures(7, 3, 1024, "cpu")
    intr = (90.0, 90.0, 63.5, 23.5)
    f0 = scenes.render(scenes.CORRIDOR, tex, 40.0, intr, *drive.pose(0, wrap=True), 48, 128)
    fP = scenes.render(scenes.CORRIDOR, tex, 40.0, intr, *drive.pose(period, wrap=True), 48, 128)
    assert torch.equal(scenes.to_u8(f0), scenes.to_u8(fP))
    c0 = -drive.pose(0)[0].T @ drive.pose(0)[1]
    cP = -drive.pose(period)[0].T @ drive.pose(period)[1]
    np.testing.assert_allclose(cP - c0, [0.0, 0.0, step * period], atol=1e-9)


def test_drive_refuses_a_period_off_the_texture():
    with pytest.raises(ValueError):
        scenes.Drive(0.8, 150, 1.0, 1024, 40.0)


def test_right_camera_is_a_baseline_along_x():
    R = scenes.yaw_matrix(0.1).T
    t = -R @ np.array([1.0, 0.0, 5.0])
    Rr, tr = scenes.right_pose(R, t, 0.537)
    np.testing.assert_allclose(R @ (-Rr.T @ tr) + t, [0.537, 0.0, 0.0], atol=1e-12)


def test_png_round_trip_through_the_native_decoder(tmp_path):
    """The benchmark's encoder's files decode to the same bytes through
    the port's native decoder, as the PNG cell's ring reads them."""
    from viso_tpu_torch.data import native

    from vobench import pngenc

    if not native.available():
        pytest.skip(f"the native decoder is unavailable: {native._load_error}")
    img = scenes.to_u8(scenes.render(scenes.CORRIDOR, scenes.textures(9, 3, 256, "cpu"), 40.0,
                                     (90.0, 90.0, 63.5, 23.5), np.eye(3), np.zeros(3), 48, 128))
    path = str(tmp_path / "000000.png")
    pngenc.write_gray(path, img.numpy())
    assert np.array_equal(native.decode_gray(path), img.numpy().astype(np.float32))
