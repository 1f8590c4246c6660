"""Pixel-framework ops: exact-semantics checks against the C formulas."""
import numpy as np
import pytest

from yaik_tpu.ops import plane as P
from yaik_tpu.ops import segments as S


def test_operator_masks():
    a = np.array([[1, 5, 5], [7, 0, 5]])
    assert (P.operator_mask(a, "eq", 5) ==
            np.array([[0, 255, 255], [0, 0, 255]])).all()
    assert (P.operator_mask(a, "lt", 5) ==
            np.array([[255, 0, 0], [0, 255, 0]])).all()


def test_ycocg_roundtrip_exact():
    """YCoCgPos roundtrip: the reference's own recode path (convert then
    invert); lossy /2 chroma means *2 on the way back - check the exact
    integer pipeline against brute force."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (1000, 3)).astype(np.int64)
    y, co, cg = P.rgb_to_ycocg_pos(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    assert (co >= 0).all() and (co <= 254).all()
    r, g, b = P.ycocg_pos_to_rgb(y, co, cg)

    def ref_one(R, G, B):
        Co = R - B
        tmp = B + int(Co / 2 if Co >= 0 else -((-Co) // 2))
        Cg = G - tmp
        Y = tmp + int(Cg / 2 if Cg >= 0 else -((-Cg) // 2))
        return Y, int(Co / 2 if Co >= 0 else -((-Co) // 2)) + 127, \
            int(Cg / 2 if Cg >= 0 else -((-Cg) // 2)) + 127
    for i in range(50):
        assert (y[i], co[i], cg[i]) == ref_one(*map(int, rgb[i]))


def test_compress_uncompress_pair():
    v = np.arange(256)
    c = P.compress_f(v, 250)
    u = P.uncompress_f(c, 250)
    # the reference pair is a mul-inverse: error bounded by posterization
    assert np.abs(u - v).max() <= 2
    assert (P.round6(np.array([255])) == 255).all()
    assert (P.round6(np.array([0])) == 0).all()


def test_sampling():
    a = np.arange(16).reshape(4, 4)
    d = P.sample_down(a, True, True, "average")
    assert d.shape == (2, 2)
    assert d[0, 0] == (0 + 1 + 4 + 5) // 4
    assert (P.sample_down(a, True, True, "nearest_tl")
            == a[::2, ::2]).all()
    assert (P.sample_down(a, True, True, "max") == a[1::2, 1::2]).all()
    u = P.sample_up(a, True, True)
    assert u.shape == (8, 8)
    assert (u[::2, ::2] == a).all() and (u[1::2, 1::2] == a).all()


def test_erosion_culls_small_regions():
    m = np.zeros((32, 32), int)
    m[2, 2] = 255                      # single speck
    m[10, 10:12] = 255                 # 2-wide speck
    m[20:30, 20:30] = 255              # 100-px region: survives
    P.erosion(m)
    assert m[2, 2] == 0 and m[10, 10] == 0
    assert (m[20:30, 20:30] == 255).all()


def test_reduce_quarter():
    m = np.zeros((4, 4), int)
    m[0:2, 0:2] = 255
    q = P.reduce_quarter_logic_max(m)
    assert q[0, 0] == 255 and q[0, 1] == 0


def test_histogram_rgb():
    img = np.zeros((2, 4, 3), np.uint8)
    img[0, 0] = (1, 2, 3)
    colors, counts = P.histogram_rgb(img)
    assert counts[0] == 7 and tuple(colors[0]) == (0, 0, 0)
    assert counts[1] == 1 and tuple(colors[1]) == (1, 2, 3)


def test_apply_diff():
    a = np.array([[3, 5], [9, 4]])
    d = P.apply_diff(a)
    assert d[0, 0] == 3 and d[0, 1] == 2 and d[1, 0] == 9 and d[1, 1] == -5


def test_segment_distance():
    d, u = S.segment_distance_3d(np.array([[0, 1, 0], [2, 0, 0]]),
                                 (0, 0, 0), (1, 0, 0))
    assert abs(d[0] - 1.0) < 1e-6 and abs(u[0] - 0.0) < 1e-6
    assert abs(d[1] - 1.0) < 1e-6 and abs(u[1] - 1.0) < 1e-6


def test_segment_lut_ctx():
    ctx = S.build_ctx_from_segments([(0, 0, 0, 63, 63, 63)])
    assert ctx.factors[3].shape == (8, 3)
    assert int(ctx.factors[6][0].sum()) == 0
    assert ctx.position[3].shape == (64, 64, 64)
    # the diagonal voxel (32,32,32) should be near the mid entry
    assert 2 <= int(ctx.position[3][32, 32, 32]) <= 5


@pytest.mark.slow
def test_mining_produces_loadable_bank(tmp_path):
    from yaik_tpu.encoder import bank as bankmod, mining
    rng = np.random.default_rng(7)
    # content with correlated ramps so captures exist
    t = np.linspace(0, 1, 64)[None, :, None]
    img = (np.concatenate([t * 255, t * 200 + 30, (1 - t) * 255], axis=2)
           * np.ones((64, 1, 1)))
    img = (img + rng.normal(0, 2.2, img.shape)).clip(0, 255).astype(np.uint8)
    n, total = mining.mine_bank([img], tmp_path)
    assert n >= 1 and total >= 1
    bank = bankmod.load_bank(str(tmp_path))
    assert bank.count == n
    from yaik_tpu.encoder.context import encode_image
    from yaik_tpu.decoder import api
    stream = encode_image(img, bank)
    out = api.decode_image(stream, bankmod.write_lut_file(bank))
    assert out.shape == img.shape
