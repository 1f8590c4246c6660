"""yaik_tpu command line (the reference's ImageEncoder.exe / test app,
unified):

  python -m yaik_tpu encode  img.png out.yaik  [--bank DIR] [--engine host|device] [--stats]
  python -m yaik_tpu decode  in.yaik out.png   [--lut FILE] [--engine host|jax]
  python -m yaik_tpu lut     bank_dir out.lut            (build LutFile.lut)
  python -m yaik_tpu stats   in.yaik                     (per-technique report)
  python -m yaik_tpu mine    out_dir imgs...  [--mode 2d] (LUT-bank mining)
  python -m yaik_tpu mine-report out_dir imgs... (mine + corpus bpp/PSNR
                                  report vs a baseline bank, one command)
  python -m yaik_tpu roundtrip img.png                   (encode+decode+PSNR)
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

DEFAULT_FIX = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"


def _load_bank(path):
    from yaik_tpu.encoder import bank as bankmod
    bank = bankmod.load_bank(str(path))
    if bank.count == 0:
        sys.exit(f"no bank files found in {path}")
    return bank


def _png(path):
    from yaik_tpu.utils import png
    return png.read_png(path)


def _maybe_trace(args):
    """jax.profiler trace context (SURVEY section 5: the reference has only
    wall timers; the rebuild exposes real device traces)."""
    import contextlib
    if not getattr(args, "trace", None):
        return contextlib.nullcontext()
    import jax
    return jax.profiler.trace(args.trace)


def cmd_encode(args):
    from yaik_tpu.encoder.context import EncoderConfig, encode_image
    bank = _load_bank(args.bank)
    img = _png(args.input)
    cfg = EncoderConfig(enable_single_color=args.enable_single_color,
                        enable_2d=args.enable_2d)
    bank2d = None
    if args.enable_2d:
        from yaik_tpu.encoder import bank2d as bank2dmod
        bank2d = bank2dmod.load_bank2d(str(args.bank2d))
        if bank2d.count == 0:
            sys.exit(f"no Bank2D patterns found in {args.bank2d}")
    from yaik_tpu.utils import profiler
    import contextlib
    prof = profiler.enable() if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof, _maybe_trace(args):
        stream = encode_image(img, bank, cfg, engine=args.engine,
                              bank2d=bank2d)
    dt = time.perf_counter() - t0
    pathlib.Path(args.output).write_bytes(stream)
    h, w = img.shape[:2]
    print(f"{args.input}: {w}x{h} -> {len(stream)} B "
          f"({len(stream)*8/(w*h):.3f} bpp) in {dt:.2f}s")
    from yaik_tpu.utils.stats import accumulate_global, analyze
    st = analyze(stream)
    # the reference always writes <out>.yaik.log.txt (EncoderContext.cpp:9480)
    pathlib.Path(args.output + ".log.txt").write_text(st.summary() + "\n")
    if args.global_stats:
        acc = accumulate_global(args.global_stats, st)
        print(f"global: {acc['images']} images, {acc['bpp']:.3f} bpp "
              f"({args.global_stats})")
    if args.stats:
        print(st.summary())
    if args.profile:
        from yaik_tpu.utils import profiler
        print(profiler.report())


def cmd_decode(args):
    from yaik_tpu.decoder import api
    from yaik_tpu.utils import png
    stream = pathlib.Path(args.input).read_bytes()
    lut2d = (pathlib.Path(args.lut2d).read_bytes()
             if args.lut2d else None)
    lut = api.assign_lut(pathlib.Path(args.lut).read_bytes(), lut2d)
    from yaik_tpu.utils import profiler
    import contextlib
    prof = profiler.enable() if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof, _maybe_trace(args):
        img = api.decode_image(stream, lut, engine=args.engine)
    dt = time.perf_counter() - t0
    png.write_png(args.output, img)
    print(f"{args.input}: {img.shape[1]}x{img.shape[0]}"
          f"{'+A' if img.shape[2] == 4 else ''} in {dt:.2f}s -> {args.output}")
    if args.profile:
        print(profiler.report())


def cmd_lut(args):
    if args.mode == "2d":
        from yaik_tpu.encoder import bank2d as bank2dmod
        bank = bank2dmod.load_bank2d(args.bank_dir)
        data = bank2dmod.write_lut2d_file(bank)
    else:
        from yaik_tpu.encoder import bank as bankmod
        bank = _load_bank(args.bank_dir)
        data = bankmod.write_lut_file(bank)
    pathlib.Path(args.output).write_bytes(data)
    print(f"{bank.count} tables -> {args.output} ({len(data)} B)")


def cmd_mine(args):
    from yaik_tpu.encoder import mining
    from yaik_tpu.utils import png
    imgs = [png.read_png(p, rgb=True) for p in args.images]
    if args.mode == "2d":
        n, total = mining.mine_bank2d(imgs, args.out_dir,
                                      max_tables=args.max_tables,
                                      engine=args.engine)
    else:
        n, total = mining.mine_bank(imgs, args.out_dir,
                                    max_tables=args.max_tables,
                                    checkpoint=args.checkpoint,
                                    engine=args.engine)
    print(f"{n} bank tables from {total} captured tiles -> {args.out_dir}")


def cmd_stats(args):
    from yaik_tpu.utils.stats import analyze
    stream = pathlib.Path(args.input).read_bytes()
    st = analyze(stream)
    print(st.to_json() if args.json else st.summary())


def cmd_mine_report(args):
    """Close the research loop with a RESULT (the reference's
    capture + evaluateLUT workflow exists to minimize file size,
    EncoderContext.cpp:6350-6433/:8904-8985 + README.md:108-161): mine a
    bank from the corpus, then encode the SAME corpus with the baseline
    bank and with the mined bank at IDENTICAL acceptance gates and report
    corpus bpp, PSNR, and per-technique pixel shares for both."""
    import json as _json

    from yaik_tpu.decoder import api
    from yaik_tpu.encoder import bank as bankmod
    from yaik_tpu.encoder import mining
    from yaik_tpu.encoder.batch import encode_corpus
    from yaik_tpu.utils import png
    from yaik_tpu.utils.stats import analyze

    imgs = [png.read_png(p, rgb=True) for p in args.images]
    n, total = mining.mine_bank(imgs, args.out_dir,
                                max_tables=args.max_tables,
                                checkpoint=args.checkpoint,
                                engine=args.engine,
                                max_candidates=args.max_candidates)
    print(f"mined {n} tables from {total} captured tiles -> {args.out_dir}")
    banks = {"baseline": _load_bank(args.bank),
             "mined": bankmod.load_bank(args.out_dir)}
    report = {"corpus_images": len(imgs),
              "captured_tiles": total, "mined_tables": n,
              "baseline_bank": str(args.bank), "mined_bank": args.out_dir,
              "gates": "reference defaults (gradient rejectFactor=3; 3D "
                       "max channel err<=5, <=3 violators/tile)",
              "banks": {}}
    for name, bank in banks.items():
        streams = encode_corpus(imgs, bank, batch_size=args.batch)
        lut = api.assign_lut(bankmod.write_lut_file(bank))
        bits = px = 0
        mse_sum = 0.0
        tech = {"gradient": 0, "tile3d": 0, "residual_1d": 0}
        bitpx = {}
        for img, stream in zip(imgs, streams):
            h, w = img.shape[:2]
            bits += len(stream) * 8
            px += h * w
            dec = api.decode_image(stream, lut)
            mse_sum += float(((img[:, :, :3].astype(np.float64)
                               - dec[:, :, :3].astype(np.float64)) ** 2
                              ).mean())
            st = analyze(stream)
            tech["gradient"] += sum(st.gradient_pixels.values())
            tech["tile3d"] += sum(st.tile3d_pixels.values())
            tech["residual_1d"] += st.pixels_1d
            for b, v in st.tile3d_bit_pixels.items():
                bitpx[str(b)] = bitpx.get(str(b), 0) + v
        mse = mse_sum / len(imgs)
        report["banks"][name] = {
            "bpp": round(bits / px, 4),
            "psnr_db": round(10 * np.log10(255 ** 2 / mse), 3)
            if mse else None,
            "technique_pixel_share": {
                k: round(v / px, 4) for k, v in tech.items()},
            "tile3d_bit_pixels": bitpx,
        }
        print(f"{name}: {report['banks'][name]['bpp']} bpp, "
              f"PSNR {report['banks'][name]['psnr_db']} dB")
    base_bpp = report["banks"]["baseline"]["bpp"]
    mined_bpp = report["banks"]["mined"]["bpp"]
    report["bpp_delta_pct"] = round(100 * (mined_bpp - base_bpp)
                                    / base_bpp, 2)
    out = pathlib.Path(args.report)
    out.write_text(_json.dumps(report, indent=1))
    print(f"bpp delta (mined vs baseline): {report['bpp_delta_pct']:+.2f}%"
          f"  -> {out}")


def cmd_roundtrip(args):
    from yaik_tpu.decoder import api
    from yaik_tpu.encoder import bank as bankmod
    from yaik_tpu.encoder.context import encode_image
    bank = _load_bank(args.bank)
    img = _png(args.input)
    stream = encode_image(img, bank, engine=args.engine)
    lut = api.assign_lut(bankmod.write_lut_file(bank))
    dec = api.decode_image(stream, lut)
    rgb_in, rgb_out = img[:, :, :3].astype(float), dec[:, :, :3].astype(float)
    mse = np.mean((rgb_in - rgb_out) ** 2)
    psnr = 10 * np.log10(255 ** 2 / mse) if mse else float("inf")
    h, w = img.shape[:2]
    print(f"{args.input}: {len(stream)*8/(w*h):.3f} bpp  PSNR {psnr:.2f} dB")


def main():
    p = argparse.ArgumentParser(prog="yaik_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode")
    e.add_argument("input"); e.add_argument("output")
    e.add_argument("--bank", default=DEFAULT_FIX / "Bank3D")
    e.add_argument("--engine", default="host", choices=["host", "device"])
    e.add_argument("--stats", action="store_true")
    e.add_argument("--enable-single-color", action="store_true",
                   help="UCOL pass (disabled in the reference, "
                        "EncoderContext.cpp:9036)")
    e.add_argument("--enable-2d", action="store_true",
                   help="2DTL plane-pair passes (disabled upstream)")
    e.add_argument("--bank2d", default=DEFAULT_FIX / "Bank2D")
    e.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a jax.profiler device trace into DIR "
                        "(view with TensorBoard / Perfetto)")
    e.add_argument("--profile", action="store_true",
                   help="print per-stage host timings")
    e.add_argument("--global-stats", metavar="PATH", default=None,
                   help="accumulate corpus statistics across runs "
                        "(globalStats.bin analog, JSON)")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode")
    d.add_argument("input"); d.add_argument("output")
    d.add_argument("--lut", default=DEFAULT_FIX / "LutFile.lut")
    d.add_argument("--lut2d", default=None,
                   help="LutFile2D.lut for streams with 2DTL chunks")
    d.add_argument("--engine", default="host", choices=["host", "jax"])
    d.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a jax.profiler device trace into DIR")
    d.add_argument("--profile", action="store_true",
                   help="print per-stage host timings")
    d.set_defaults(fn=cmd_decode)

    l = sub.add_parser("lut")
    l.add_argument("bank_dir"); l.add_argument("output")
    l.add_argument("--mode", default="3d", choices=["3d", "2d"],
                   help="2d builds a LutFile2D.lut from Bank2D PNGs")
    l.set_defaults(fn=cmd_lut)

    m = sub.add_parser("mine", help="mine a LUT bank from training images")
    m.add_argument("out_dir")
    m.add_argument("images", nargs="+")
    m.add_argument("--mode", default="3d", choices=["3d", "2d"])
    m.add_argument("--max-tables", type=int, default=12)
    m.add_argument("--checkpoint", default=None,
                   help="capture-phase checkpoint file (resumable)")
    m.add_argument("--engine", default="host", choices=["host", "device"],
                   help="device: fused-gradient capture claims (3d) and"
                        " on-device coverage matrices (both modes);"
                        " bit-identical picks")
    m.set_defaults(fn=cmd_mine)

    s = sub.add_parser("stats")
    s.add_argument("input")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_stats)

    mr = sub.add_parser(
        "mine-report",
        help="mine a bank AND report corpus bpp/PSNR vs a baseline bank "
             "at identical acceptance gates (one-command research loop)")
    mr.add_argument("out_dir")
    mr.add_argument("images", nargs="+")
    mr.add_argument("--bank", default=DEFAULT_FIX / "Bank3D",
                    help="baseline bank to beat")
    mr.add_argument("--report", default="mine_report.json")
    mr.add_argument("--max-tables", type=int, default=12)
    mr.add_argument("--max-candidates", type=int, default=256)
    mr.add_argument("--batch", type=int, default=8)
    mr.add_argument("--checkpoint", default=None)
    mr.add_argument("--engine", default="host",
                    choices=["host", "device"])
    mr.set_defaults(fn=cmd_mine_report)

    r = sub.add_parser("roundtrip")
    r.add_argument("input")
    r.add_argument("--bank", default=DEFAULT_FIX / "Bank3D")
    r.add_argument("--engine", default="host", choices=["host", "device"])
    r.set_defaults(fn=cmd_roundtrip)

    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
