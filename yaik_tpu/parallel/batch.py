"""Scale-out: batch decode over a device mesh + spatial sharding for
monster images.

YAIK's parallelism axes (SURVEY section 2.5): there is no TP/PP/SP/EP
analog in a codec - the axes are (a) tile-parallel inside the kernels,
(b) DATA-parallel over the image batch (config 5: texture corpora on a
device mesh), and (c) spatial sharding of one large image's tile grid
(config 4: 4K stills), which is what `decode_spatial` does by splitting
the dense decode plan into horizontal bands (every plan tensor is
tile-grid-indexed, so bands are pure slices; the corner grids carry their
one-row halo naturally).

All plan content splits: gradient passes (incl. plane-variant GTIL),
3D-LUT passes, the UCOL/SMAP overlay, 2DTL passes, the 1D residual, and
the alpha channel (host-decoded, reattached after assembly).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from yaik_tpu.decoder import jax_engine, planner as plannermod
from yaik_tpu.format import lut as lutmod


def _stack_args(list_of_args):
    return jax.tree.map(lambda *xs: np.stack(xs), *list_of_args)


def _luts_of(lut):
    """(expanded3d, expanded2d|None) from raw bytes, an already-expanded
    dict, or an assign_lut handle."""
    if isinstance(lut, (bytes, bytearray)):
        return lutmod.expand_lut(lutmod.parse_lut_file(bytes(lut))), None
    if isinstance(lut, dict):
        return lut, None
    return lut.expanded, getattr(lut, "expanded2d", None)


# jitted batch decoders, cached so repeated decode_batch/decode_corpus
# calls reuse compiled executables (jit specializes per input pytree
# structure and shapes internally; the ADVICE-r1 per-call lambdas forced a
# fresh trace+compile every call)
_FN_CACHE: dict = {}


def _batched_decoder(shifts, nargs, aspec=None):
    key = (shifts, nargs, aspec)
    fn = _FN_CACHE.get(key)
    if fn is None:
        core = lambda t, *a: jax_engine.decode_core(shifts, t, *a,
                                                    aspec=aspec)
        fn = jax.jit(jax.vmap(core, in_axes=(None,) + (0,) * nargs))
        _FN_CACHE[key] = fn
    return fn


def _common_alpha_spec(plans):
    """One shared static alpha spec for a batch, or None when the streams
    mix specs (then alpha is host-decoded and reattached per image)."""
    specs = {jax_engine.alpha_spec_of(p) for p in plans}
    if len(specs) == 1:
        return specs.pop()
    return None


def _strip_alpha_arg(args):
    """Drop the per-image alpha tensors (last arg slot) when the batch
    cannot share one static alpha spec."""
    return args[:-1] + (None,)


def _put_sharded(tab, b_args, mesh):
    """Shard per-image tensors over the data axis, replicate the LUT table;
    with no mesh, plain transfers (computation follows the placed data)."""
    if mesh is None:
        return jax.device_put(tab), jax.device_put(b_args)
    sharding = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    tab = jax.device_put(np.asarray(tab), rep)
    b_args = jax.device_put(
        b_args, jax.tree.map(lambda _: sharding, b_args))
    return tab, b_args


def data_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("data",))


def decode_batch(streams, lut, mesh: Mesh | None = None):
    """Decode same-sized .yaik streams as one sharded device step.

    streams: list of bytes (all the same WxH - group by size upstream).
    Returns [B, h, w, 3] u8, or [B, h, w, 4] when the streams carry alpha
    (alpha is host-decoded per image and attached after device assembly,
    like the reference's linear-A plane, YAIK_DefaultCallback.cpp:24).
    """
    expanded, expanded2d = _luts_of(lut)
    plans = [plannermod.build_plan(s, expanded, expanded2d) for s in streams]
    w, h = plans[0].width, plans[0].height
    if any(p.width != w or p.height != h for p in plans):
        raise ValueError("decode_batch requires same-sized streams")
    withalpha = [p.has_alpha for p in plans]
    if any(withalpha) and not all(withalpha):
        raise ValueError("decode_batch cannot mix alpha/non-alpha "
                         "streams in one batch")
    aspec = _common_alpha_spec(plans)
    layout = jax_engine.batch_layout(plans, expanded)
    all_args = []
    shifts = None
    for p in plans:
        shifts, tab, a = jax_engine.plan_to_device_args(p, expanded,
                                                        expanded2d,
                                                        layout=layout)
        all_args.append(a if aspec is not None else _strip_alpha_arg(a))
    b_args = _stack_args(all_args)

    fn = _batched_decoder(shifts, len(b_args), aspec)
    tab, b_args = _put_sharded(tab, b_args, mesh)
    out = np.asarray(fn(tab, *b_args))[:, :h, :w]
    if any(withalpha) and out.shape[3] == 3:
        # mixed alpha specs: device did RGB, reattach host-decoded alpha
        alpha = np.stack([p.host_alpha() for p in plans])
        out = np.concatenate([out, alpha[:, :, :, None]], axis=3)
    return out


def split_plan_bands(plan: plannermod.DecodePlan, n_bands: int):
    """Slice a decode plan into <= n_bands horizontal bands. Band starts
    are 16px-aligned (the largest tile grid, 16x16 gradients), so every
    pass's tile grid splits cleanly; the LAST band absorbs the remainder
    and may be shorter (real 4K: 2160 = 4x544 + 16). Carries EVERY plan
    field: gradient passes (incl. plane variants), 3D passes, the
    UCOL/SMAP overlay, 2DTL passes, 1D residual, and alpha."""
    h, w = plan.height, plan.width
    bh_nom = -(-(-(-h // n_bands)) // 16) * 16    # ceil(h/n) up to 16-mult
    if bh_nom >= h:
        return [plan]
    starts = list(range(0, h, bh_nom))
    bands = []
    for y0 in starts:
        bh = min(bh_nom, h - y0)
        grads = []
        for g in plan.gradient:
            sx, sy = g.shift
            th = 1 << sy
            r0, r1 = y0 // th, (y0 + bh) // th
            q0, q1 = y0 // 4, (y0 + bh) // 4
            grads.append(plannermod.GradientPassPlan(
                shift=g.shift, accept=g.accept[r0:r1],
                corners=g.corners[q0:q1 + 1], plane_mask=g.plane_mask))
        t3 = []
        for p in plan.tile3d:
            sx, sy = p.shift
            tw, th = 1 << sx, 1 << sy
            ntx = w // tw
            r0, r1 = (y0 // th) * ntx, ((y0 + bh) // th) * ntx
            t3.append(plannermod.Tile3DPassPlan(
                shift=p.shift, accept=p.accept[y0 // th:(y0 + bh) // th],
                colors=p.colors[r0:r1], packed=p.packed[r0:r1],
                types=p.types[r0:r1] if p.types is not None else None))
        t2 = None
        if plan.tile2d:
            t2 = []
            for p in plan.tile2d:
                sx, sy = p.shift
                tw, th = 1 << sx, 1 << sy
                ntx = w // tw
                r0, r1 = (y0 // th) * ntx, ((y0 + bh) // th) * ntx
                t2.append(plannermod.Tile2DPassPlan(
                    mode=p.mode, shift=p.shift,
                    accept=p.accept[y0 // th:(y0 + bh) // th],
                    types=p.types[r0:r1], colors=p.colors[r0:r1],
                    packed=p.packed[r0:r1]))
        overlay = None
        if plan.overlay is not None:
            overlay = plannermod.PlanOverlay(
                vals=plan.overlay.vals[y0:y0 + bh],
                mask=plan.overlay.mask[y0:y0 + bh])
        ntx8 = w // 8
        r0, r1 = (y0 // 8) * ntx8, ((y0 + bh) // 8) * ntx8
        d1 = plannermod.Plan1D(params=plan.d1.params[:, r0:r1],
                               indices=plan.d1.indices[:, r0:r1],
                               wmask=plan.d1.wmask[:, r0:r1])
        bands.append(plannermod.DecodePlan(
            width=w, height=bh, gradient=grads, tile3d=t3, d1=d1,
            overlay=overlay, tile2d=t2))
    return bands


def decode_spatial(stream: bytes, lut, mesh: Mesh | None = None,
                   n_bands: int | None = None):
    """Decode ONE large image with its tile grid sharded across devices.
    Returns [h, w, 3] u8 ([h, w, 4] when the stream carries alpha)."""
    expanded, expanded2d = _luts_of(lut)
    plan = plannermod.build_plan(stream, expanded, expanded2d)
    n = n_bands or (len(mesh.devices.flat) if mesh is not None
                    else len(jax.devices()))
    bands = split_plan_bands(plan, n)
    if mesh is not None and len({b.height for b in bands}) != 1:
        raise ValueError(
            "mesh-sharded spatial decode needs equal bands: image height "
            f"{plan.height} does not split into {n} equal 16px-multiple "
            "bands (drop the mesh or pick a dividing n_bands)")
    # bands group by height: all nominal-height bands batch through one
    # executable; an uneven remainder band (real 4K: 2160 = 4x544 + 16)
    # decodes through its own
    parts = []
    i = 0
    while i < len(bands):
        j = i
        while j < len(bands) and bands[j].height == bands[i].height:
            j += 1
        grp = bands[i:j]
        layout = jax_engine.batch_layout(grp, expanded)
        shifts, tab, args0 = jax_engine.plan_to_device_args(
            grp[0], expanded, expanded2d, layout=layout)
        all_args = [args0] + [
            jax_engine.plan_to_device_args(b, expanded, expanded2d,
                                           layout=layout)[2]
            for b in grp[1:]]
        b_args = _stack_args(all_args)
        fn = _batched_decoder(shifts, len(b_args))
        tab, b_args = _put_sharded(tab, b_args, mesh)
        out = np.asarray(fn(tab, *b_args))
        parts.append(out.reshape(len(grp) * out.shape[1], out.shape[2], 3))
        i = j
    full = np.concatenate(parts, axis=0)
    rgb = full[: plan.height, : plan.width]
    if plan.has_alpha:
        rgb = np.concatenate([rgb, plan.host_alpha()[:, :, None]], axis=2)
    return rgb


def decode_corpus(streams, lut, batch_size: int = 8,
                  planner_workers: int | None = None,
                  mesh: Mesh | None = None) -> list[np.ndarray]:
    """End-to-end pipelined corpus decode: while the device renders batch
    k's pixels, the host plans batch k+1's streams. Streams are
    grouped by image size; short batches are padded so every dispatch hits
    the compiled executable. Returns RGB(A) arrays in input order,
    bit-exact with decode_image (tested).

    planner_workers: thread count for within-batch planning (default
    cpu_count). The hot planning stages - zstd, the palette codec, and the
    native pass-scatter replay - are ctypes calls that release the GIL, so
    planning scales across host cores.

    mesh: optional data-parallel mesh; each dispatched batch is sharded
    over its "data" axis (batch_size must divide evenly)."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from yaik_tpu.decoder.api import decode_image_pre
    expanded, expanded2d = _luts_of(lut)
    if mesh is not None and batch_size % mesh.devices.size:
        raise ValueError("batch_size must be a multiple of the mesh size")
    results: list = [None] * len(streams)
    n_workers = planner_workers or os.cpu_count() or 1
    pool = ThreadPoolExecutor(n_workers) if n_workers > 1 else None

    try:
        # group by size from the header alone; planning stays in the pipeline
        groups: dict = {}
        for i, s in enumerate(streams):
            w, h, _ = decode_image_pre(s)
            groups.setdefault((w, h), []).append(i)

        for (w, h), idxs in groups.items():
            def plan_and_dispatch(chunk):
                if pool is not None:
                    plans = list(pool.map(
                        lambda i: plannermod.build_plan(
                            streams[i], expanded, expanded2d),
                        chunk))
                else:
                    plans = [plannermod.build_plan(streams[i], expanded,
                                                   expanded2d)
                             for i in chunk]
                aspec = _common_alpha_spec(plans)
                layout = jax_engine.batch_layout(plans, expanded)
                args = []
                for p in plans:
                    shifts, tab, a = jax_engine.plan_to_device_args(
                        p, expanded, expanded2d, layout=layout)
                    args.append(a if aspec is not None
                                else _strip_alpha_arg(a))
                fn = _batched_decoder(shifts, len(args[0]), aspec)
                args += [args[0]] * (batch_size - len(args))
                tab_d, b_args = _put_sharded(tab, _stack_args(args), mesh)
                out = fn(tab_d, *b_args)
                out.copy_to_host_async()   # download overlaps the next plan
                return out, plans

            pending = None
            for s in range(0, len(idxs), batch_size):
                chunk = idxs[s:s + batch_size]
                # planning chunk k+1 here overlaps the device decode of
                # chunk k
                handle = plan_and_dispatch(chunk)
                if pending is not None:
                    _drain(pending, results, w, h)
                pending = (chunk, *handle)
            _drain(pending, results, w, h)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
    return results


def _drain(pending, results, w, h):
    chunk, out, plans = pending
    arr = np.asarray(out)
    for j, i in enumerate(chunk):
        rgb = arr[j, :h, :w]
        if plans[j].has_alpha and rgb.shape[2] == 3:
            # mixed-spec batch fell back to device RGB + host alpha
            rgb = np.concatenate([rgb, plans[j].host_alpha()[:, :, None]],
                                 axis=2)
        results[i] = rgb
