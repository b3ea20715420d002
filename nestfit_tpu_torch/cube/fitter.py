"""Batched cube fitter (port of ``nestfit_tpu/cube/fitter.py``).

Every valid pixel of a cube stack climbs the 1..``ncomp_max`` component
ladder in pixel batches: pixels are bucketed by SNR into a few live-point
classes, each batch fits rung N for the survivors of rung N-1 only, runs
that break the nested-model evidence floor are re-fitted (mode-loss
retry), runs near the Bayes-factor gate are re-fitted at a higher live
count (boundary refinement), and the gate picks ``nbest`` per pixel.

The device work and the store write are separate steps:
``CubeFitter._fit_batches`` runs the batches on the fitter's device and
hands back host NumPy records per batch (``BatchRecords``);
``CubeFitter.fit_cube`` writes them into the chunked HDF5 store
(``cube/store.py``, the only module that needs ``h5py``).

Randomness: every ``fit_batch`` call gets its own ``torch.Generator`` on
the fitter's device, seeded from ``np.random.SeedSequence(seed)`` spawned
per batch, batch attempt, rung, and mode-loss attempt or boundary pass,
so one seed replays the same run on one device.

Multi-device and multi-process: ``mesh=`` splits every batch over the
mesh's dp rows (``fit_batch(mesh=)``); ``fit_cube(host_shard=True)``
gives each process an interleaved stripe of the valid pixels, its own
seed stream and its own ``chunk_h<process>_<j>.hdf`` files
(:func:`host_share`, which the store-free ``_fit_batches`` path shares).
"""

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch

from nestfit_tpu_torch.cube.records import fit_group_records
from nestfit_tpu_torch.device import resolve_device
from nestfit_tpu_torch.parallel import distributed
from nestfit_tpu_torch.sampling.fit import align_fit_meta, fit_batch, \
    merge_fit_rows
from nestfit_tpu_torch.sampling.results import resolve_n_post
from nestfit_tpu_torch.sampling.sampler import NSConfig
from nestfit_tpu_torch.utils.profiling import collect, now_ns, span, \
    to_host

log = logging.getLogger("nestfit_tpu_torch.fitter")


def bucket_nlive(nlive_arr, n_buckets=4, quantum=50):
    """Quantize per-pixel live-point counts into at most ``n_buckets``
    classes, each ceiling snapped up to ``quantum``.  Returns
    ``(assigned level per pixel, levels)``."""
    nlive_arr = np.asarray(nlive_arr)
    qs = np.unique(
        np.quantile(nlive_arr, np.linspace(0, 1, n_buckets + 1)[1:])
    )
    levels = np.unique((np.ceil(qs / quantum) * quantum).astype(int))
    assign = levels[np.searchsorted(levels, nlive_arr, side="left")]
    return assign, levels


@dataclasses.dataclass
class BatchRecords:
    """What one pixel batch of the ladder hands back, on the host.

    ``records`` holds ``(pixel, ncomp, record)`` for every run the store
    keeps (``records.fit_group_record`` form); ``rungs`` one dict of
    measurements per rung (wall, evals per pixel, retry and boundary
    rows); ``attempts`` the ladder runs the batch took (more than 1 when
    a run raised and the batch was re-run with fresh seeds); ``trace``
    the ``utils.profiling.Trace`` of the batch: the spans, counters and
    host reads of the ladder, the fits and the sampler.  The walls of
    ``rungs`` are the lengths of its spans ``cube.first_pass`` (``wall``),
    ``cube.rung`` (``total_wall``), ``cube.mode_loss_retry`` and
    ``cube.boundary``."""

    chunk: int                  # index of the batch (its chunk file)
    nlive: int                  # the batch's SNR-bucket live-point level
    pixel_ix: np.ndarray        # flat pixel ids of the batch
    nbest: np.ndarray           # selected ncomp per pixel
    records: list
    rungs: list
    attempts: int = 1
    trace: object = None


def _generator(ss, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return gen


def host_rank(host_shard=False, process_id=None, process_count=None):
    """``(process index, process count)`` of a fit: ``(0, 1)`` unless
    ``host_shard``, then the arguments or the process group's rank and
    size."""
    if not host_shard:
        return 0, 1
    pi = distributed.rank() if process_id is None else int(process_id)
    pc = distributed.world_size() if process_count is None \
        else int(process_count)
    if not 0 <= pi < pc:
        raise ValueError(f"process {pi} of {pc}")
    return pi, pc


def host_share(pixel_ix, seed, pi=0, pc=1):
    """The pixels process ``pi`` of ``pc`` fits and the root of its seed
    stream: the interleaved stripe of ``pixel_ix`` (spatially clustered
    signal spreads evenly over processes) and
    ``np.random.SeedSequence(seed).spawn(pc)[pi]``; a single process
    fits every pixel from ``SeedSequence(seed)`` itself."""
    pixel_ix = np.asarray(pixel_ix, dtype=np.int64)
    if pc == 1:
        return pixel_ix, np.random.SeedSequence(seed)
    shard_ix = pixel_ix[distributed.host_pixel_stripe(pixel_ix.size, pi, pc)]
    return shard_ix, np.random.SeedSequence(seed).spawn(pc)[pi]


def _log_batch(chunk, tr):
    """Log a batch's trace: its wall, the sampler's counters and the
    host reads by layer (count, seconds waited)."""
    reads = {}
    for site, (c, w) in tr.syncs.items():
        layer = site.split(".")[0]
        c0, w0 = reads.get(layer, (0, 0))
        reads[layer] = (c0 + c, w0 + w)
    wall = sum((t1 - t0) / 1e9 for _n, t0, t1, depth, _a in tr.spans
               if depth == 0)
    n = tr.counters
    log.info("batch %d: %.1fs, %d iterations in %d segments (%d blocks, "
             "%d compactions), host reads %s", chunk, wall,
             n.get("ns.iterations", 0), n.get("ns.segments", 0),
             n.get("ns.blocks", 0), n.get("ns.compactions", 0),
             ", ".join(f"{k} {c} ({w / 1e9:.2f}s)"
                       for k, (c, w) in sorted(reads.items())))


class CubeFitter:
    """Fit every pixel of a cube stack with the N-component ladder.

    Parameters and defaults are the JAX package's: ``lnZ_thresh``
    (Bayes-factor gate, 11), ``ncomp_max`` (2), ``nlive_snr_fact`` (5),
    the sampler kwargs (nlive 100, tol 1.0, init_factor 4),
    ``mode_loss_margin``/``mode_loss_retries`` (8 nats, 2 retries) and
    ``boundary_band``/``boundary_nlive_mult`` (6 nats, 2x nlive).
    ``utrans`` is the prior transformer; ``device`` (default ``"cuda"``,
    raises without a card) is where every batch runs.  ``max_retries``
    re-runs a failed batch with fresh seeds before leaving its pixels
    to a later ``fit_cube(..., resume=True)``.  ``mesh``
    (``parallel.make_mesh``) splits every batch over the mesh's dp rows
    (and the spectra over its sp devices); the batches are then padded
    to a multiple of dp, and the results gathered on ``device``.
    """

    ns_default_kwargs = {"nlive": 100, "tol": 1.0, "init_factor": 4}

    def __init__(self, stack, utrans, runner_cls, runner_kwargs=None,
                 lnZ_thresh=11, ncomp_max=2, ns_kwargs=None,
                 nlive_snr_fact=5, batch_size=1024, n_post=0,
                 nlive_buckets=4, segment_iters=256, mesh=None,
                 max_retries=1, mode_loss_margin=8.0,
                 mode_loss_retries=2, boundary_band=6.0,
                 boundary_nlive_mult=2, device="cuda"):
        self.device = resolve_device(device)
        self.stack = stack
        self.utrans = utrans
        self.runner_cls = runner_cls
        self.runner_kwargs = runner_kwargs or {}
        self.lnZ_thresh = lnZ_thresh
        self.ncomp_max = ncomp_max
        self.ns_kwargs = dict(self.ns_default_kwargs)
        if ns_kwargs:
            self.ns_kwargs.update(ns_kwargs)
        self.nlive_snr_fact = nlive_snr_fact
        self.batch_size = batch_size
        # one n_post for every SNR bucket, so the stored posteriors have
        # one width across the cube
        self.n_post = resolve_n_post(n_post, self.ns_kwargs["nlive"])
        self.nlive_buckets = nlive_buckets
        self.segment_iters = segment_iters
        self.mesh = mesh
        self.max_retries = max_retries
        # nested-model evidence floor: lnZ_N >= lnZ_{N-1} - margin holds
        # for the true evidences, so a run below it has lost its mode
        self.mode_loss_margin = mode_loss_margin
        self.mode_loss_retries = mode_loss_retries
        # runs whose gain lands within boundary_band of lnZ_thresh are
        # re-fitted at boundary_nlive_mult x nlive, and the refit replaces
        # them unconditionally; boundary_band=0 disables it
        self.boundary_band = boundary_band
        self.boundary_nlive_mult = boundary_nlive_mult
        self._runner_cache = {}

    @property
    def mn_kwargs(self):
        return self.ns_kwargs

    @property
    def _dp_size(self):
        return 1 if self.mesh is None else self.mesh.shape.get("dp", 1)

    def _make_runner(self, datas, noises, ncomp):
        """Batched runner over per-pixel data tensors."""
        spectra = [
            self.runner_cls.model.make_model_spectrum(
                cube.xarr, d, n, trans_id=cube.trans_id, device=self.device)
            for cube, d, n in zip(self.stack.cubes, datas, noises)
        ]
        return self.runner_cls(tuple(spectra), self.utrans, ncomp=ncomp,
                               device=self.device, **self.runner_kwargs)

    def _get_template_runner(self, ncomp, r_pad, datas, noises):
        """One runner per (ncomp, batch size); batches substitute their
        own data (``fit_batch(data=...)``) and reuse its channel terms."""
        key = (ncomp, r_pad)
        if key not in self._runner_cache:
            self._runner_cache[key] = self._make_runner(datas, noises, ncomp)
        return self._runner_cache[key]

    def _pad_quantum(self, n):
        """Next power of two (one runner per size class), rounded up to a
        multiple of the mesh's dp size (even shares per row)."""
        p = 1
        while p < n:
            p *= 2
        dp = self._dp_size
        if p % dp:
            p = int(np.ceil(n / dp)) * dp
        return max(p, dp)

    def _shard_batch(self, tree):
        """Place per-pixel tensors on the mesh, rows over ``dp``."""
        if self.mesh is None:
            return tree
        from nestfit_tpu_torch.parallel.mesh import shard_pixel_batch

        return shard_pixel_batch(self.mesh, tree)

    def _fit_rows(self, ss, rows_ix, ncomp, cfg, datas, noises):
        """``fit_batch`` of the pixels ``rows_ix``, padded to
        ``_pad_quantum`` rows by repeating the first; padding rows are
        born done (a live copy of a bright pixel would set the lockstep
        tail).  Returns ``(fit, r_pad)``."""
        n = rows_ix.size
        r_pad = self._pad_quantum(n)
        pad_ix = np.concatenate([rows_ix, np.full(r_pad - n, rows_ix[0])])
        d_b = [torch.as_tensor(np.asarray(d[pad_ix], dtype=np.float32),
                               device=self.device) for d in datas]
        n_b = [torch.as_tensor(np.asarray(np.maximum(nn[pad_ix], 1e-30),
                                          dtype=np.float32),
                               device=self.device) for nn in noises]
        template = self._get_template_runner(ncomp, r_pad, d_b, n_b)
        fit = fit_batch(
            _generator(ss, self.device), template, r_pad, cfg,
            n_post=self.n_post, segment_iters=self.segment_iters,
            data=self._shard_batch(tuple(zip(d_b, n_b))),
            active=np.arange(r_pad) < n, device=self.device, mesh=self.mesh,
        )
        return fit, r_pad

    def _escalated(self, cfg, ncomp):
        """``cfg`` at ``boundary_nlive_mult`` x nlive with the base run's
        death budget, so the refit's record rows merge."""
        ndim = self.utrans.n_param * ncomp
        return dataclasses.replace(
            cfg, nlive=self.boundary_nlive_mult * cfg.nlive,
            max_iter=cfg.resolved(ndim).max_iter,
        )

    def _refit_mode_losses(self, ss, fit, lnz, prev, cur_ix, r_pad, ncomp,
                           cfg, datas, noises, stats=None):
        """Re-fit the runs below the nested-model evidence floor
        ``lnZ_N >= lnZ_{N-1} - mode_loss_margin`` (``null_lnZ`` on the
        first rung) and keep, per pixel, whichever run reports the higher
        evidence, whole row.  Retries after the first run at
        ``boundary_nlive_mult`` x nlive.  ``ss`` is the
        ``np.random.SeedSequence`` of this step; ``stats`` (a dict)
        collects each attempt's rows and replacements: the flat ids of
        the replaced pixels, their retry lnZ and the lnZ they held before.
        Returns ``(fit, lnz)``."""
        n = cur_ix.size
        floor = prev - self.mode_loss_margin
        attempts = []
        if stats is not None:
            stats["bad_before"] = int((lnz < floor).sum())
            stats["retries"] = attempts
        for attempt, a_ss in enumerate(ss.spawn(self.mode_loss_retries)):
            bad = np.flatnonzero(lnz < floor)
            if bad.size == 0:
                break
            cfg_a = cfg if attempt == 0 else self._escalated(cfg, ncomp)
            log.warning(
                "mode-loss retry %d: %d/%d runs at ncomp=%d fell > "
                "%.0f nats below the previous rung; re-fitting%s",
                attempt + 1, bad.size, n, ncomp, self.mode_loss_margin,
                " (escalated nlive)" if attempt else "",
            )
            r_r = self._pad_quantum(bad.size)
            with span("cube.mode_loss_retry", attempt=attempt + 1,
                      rows=int(bad.size), r_pad=r_r,
                      nlive=cfg_a.nlive) as sp:
                fit_r, r_r = self._fit_rows(a_ss, cur_ix[bad], ncomp, cfg_a,
                                            datas, noises)
                lnz_r = to_host(fit_r.lnz[: bad.size], "cube.lnz")
                better = lnz_r > lnz[bad]
                dst = bad[better]
                old_lnz = lnz[dst]
                if better.any():
                    with span("cube.merge"):
                        fit = merge_fit_rows(fit, align_fit_meta(fit_r, fit),
                                             dst, np.flatnonzero(better),
                                             r_pad, r_r)
                    lnz = lnz.copy()
                    lnz[dst] = lnz_r[better]
            attempts.append(dict(
                attempt=attempt + 1, nlive=cfg_a.nlive, rows=int(bad.size),
                r_pad=r_r, replaced=int(better.sum()), pixels=cur_ix[dst],
                lnz=lnz_r[better], old_lnz=old_lnz, wall=sp.seconds))
        still = int((lnz < floor).sum())
        if stats is not None:
            stats["bad_after"] = still
        if still:
            log.warning(
                "mode-loss retry: %d runs at ncomp=%d still inconsistent "
                "after %d retries (kept best lnZ)",
                still, ncomp, self.mode_loss_retries,
            )
        return fit, lnz

    def _refine_boundary(self, ss, fit, lnz, prev, cur_ix, r_pad, ncomp,
                         cfg, datas, noises, stats=None):
        """Re-fit the runs with ``|gain - lnZ_thresh| <= boundary_band`` at
        ``boundary_nlive_mult`` x nlive (same death budget) and replace
        them unconditionally.  The stored ``n_live`` of a refined run
        stays the batch's base value; its ``n_calls`` is the refit's.
        Returns ``(fit, lnz)``."""
        if stats is not None:
            stats["boundary"] = None
        if self.boundary_band <= 0 or self.boundary_nlive_mult <= 1:
            return fit, lnz
        band = np.flatnonzero(
            np.abs(lnz - prev - self.lnZ_thresh) <= self.boundary_band)
        if band.size == 0:
            return fit, lnz
        cfg_b = self._escalated(cfg, ncomp)
        log.info(
            "boundary refine: %d/%d runs at ncomp=%d within %.0f nats "
            "of the %.0f-nat gate; re-fitting at nlive=%d",
            band.size, cur_ix.size, ncomp, self.boundary_band,
            self.lnZ_thresh, cfg_b.nlive,
        )
        with span("cube.boundary", rows=int(band.size),
                  r_pad=self._pad_quantum(band.size),
                  nlive=cfg_b.nlive) as sp:
            fit_b, r_b = self._fit_rows(ss, cur_ix[band], ncomp, cfg_b,
                                        datas, noises)
            lnz_b = to_host(fit_b.lnz[: band.size], "cube.lnz")
            with span("cube.merge"):
                fit = merge_fit_rows(fit, align_fit_meta(fit_b, fit), band,
                                     np.arange(band.size), r_pad, r_b)
            lnz = lnz.copy()
            lnz[band] = lnz_b
        if stats is not None:
            stats["boundary"] = dict(
                nlive=cfg_b.nlive, rows=int(band.size), r_pad=r_b,
                replaced=int(band.size), pixels=cur_ix[band],
                lnz=lnz_b, wall=sp.seconds)
        return fit, lnz

    def _fit_rung(self, ss, ncomp, cur_ix, prev_lnz, cfg, datas, noises):
        """One rung for the survivors ``cur_ix``: the first pass, the
        mode-loss retry and the boundary refinement.  Returns ``(fit,
        lnz, prev, stats)`` with ``prev`` the evidence each run is gated
        against (``null_lnZ`` on rung 1)."""
        s_fit, s_retry, s_band = ss.spawn(3)
        n = cur_ix.size
        with span("cube.rung", ncomp=ncomp, rows=n,
                  r_pad=self._pad_quantum(n), nlive=cfg.nlive) as rung:
            with span("cube.first_pass") as first:
                fit, r_pad = self._fit_rows(s_fit, cur_ix, ncomp, cfg, datas,
                                            noises)
                lnz = to_host(fit.lnz[:n], "cube.lnz")
            ns = fit.ns
            conv = to_host(ns.converged[:n], "cube.converged")
            n_dead = to_host(ns.n_dead[:n], "cube.n_dead")
            stats = dict(
                ncomp=ncomp, R=n, r_pad=r_pad, nlive=cfg.nlive,
                wall=first.seconds,
                evals_per_px=float(to_host(ns.ncall[:n], "cube.ncall")
                                   .astype(np.float64).mean()),
                converged=int(conv.sum()), max_iter=ns.max_iter,
                unconverged_short=int((n_dead[~conv] < ns.max_iter).sum()),
            )
            log.info("batch ladder: ncomp=%d R=%d (pad %d) nlive=%d took "
                     "%.1fs", ncomp, n, r_pad, cfg.nlive, first.seconds)
            prev = to_host(fit.null_lnz[:n], "cube.null_lnz") if ncomp == 1 \
                else prev_lnz
            fit, lnz = self._refit_mode_losses(s_retry, fit, lnz, prev,
                                               cur_ix, r_pad, ncomp, cfg,
                                               datas, noises, stats)
            fit, lnz = self._refine_boundary(s_band, fit, lnz, prev, cur_ix,
                                             r_pad, ncomp, cfg, datas,
                                             noises, stats)
        stats["total_wall"] = rung.seconds
        return fit, lnz, prev, stats

    def _fit_batch_ladder(self, ss, batch_ix, datas, noises, cfg):
        """The 1..ncomp_max ladder for one pixel batch.  Returns
        ``(nbest, records, rung stats)``, all on the host."""
        nbest = np.zeros(batch_ix.size, dtype=np.int32)
        pos_of = {pix: i for i, pix in enumerate(batch_ix)}
        cur_ix = batch_ix               # survivors (flat pixel ids)
        old_lnz = None
        records, rungs = [], []
        for ncomp, r_ss in enumerate(ss.spawn(self.ncomp_max), start=1):
            if cur_ix.size == 0:
                break
            fit, lnz, prev, stats = self._fit_rung(
                r_ss, ncomp, cur_ix, old_lnz, cfg, datas, noises)
            with span("cube.records"):
                recs = fit_group_records(fit, np.arange(cur_ix.size))
            del fit
            records.extend(zip(cur_ix.tolist(), [ncomp] * cur_ix.size, recs))
            rungs.append(stats)
            passed = lnz - prev >= self.lnZ_thresh
            for pix in cur_ix[passed]:
                nbest[pos_of[pix]] = ncomp
            cur_ix = cur_ix[passed]
            old_lnz = lnz[passed]
        return nbest, records, rungs

    def _run_batch_with_retry(self, ss, batch_ix, datas, noises, cfg,
                              chunk=0):
        """One batch (chunk ``chunk``), re-run with fresh seeds on
        failure.  Returns the ladder's ``(nbest, records, rungs)`` and the
        attempts it took, or None once ``max_retries`` is spent (its
        pixels are left for resume)."""
        for attempt, a_ss in enumerate(ss.spawn(self.max_retries + 1)):
            try:
                with span("cube.batch", chunk=chunk, nlive=cfg.nlive,
                          rows=int(batch_ix.size), attempt=attempt + 1):
                    return self._fit_batch_ladder(a_ss, batch_ix, datas,
                                                  noises, cfg), attempt + 1
            except Exception:
                if attempt >= self.max_retries:
                    log.exception(
                        "batch of %d pixels failed after %d attempts; "
                        "left for resume", batch_ix.size, attempt + 1,
                    )
                    return None
                log.exception("batch failed; retrying with fresh seeds")

    def _fit_batches(self, seed=0, pixel_ix=None, host_shard=False,
                     process_id=None, process_count=None):
        """Fit the pixels ``pixel_ix`` (flat ids; default every valid
        pixel) in SNR buckets and batches of ``batch_size``, yielding one
        ``BatchRecords`` per batch that succeeded.  Everything yielded is
        on the host.  With ``host_shard`` this process fits only its
        :func:`host_share` of them (``host_rank`` of the arguments)."""
        datas, noises, nan_mask, max_snr = self.stack.get_flat_batch()
        if pixel_ix is None:
            pixel_ix = np.nonzero(~nan_mask)[0]
        pi, pc = host_rank(host_shard, process_id, process_count)
        pixel_ix, root = host_share(pixel_ix, seed, pi, pc)
        if pc > 1:
            log.info("fit_cube: host %d/%d owns %d pixels", pi, pc,
                     pixel_ix.size)
        if pixel_ix.size == 0:
            return
        # SNR-scaled live points, bucketed into a few levels
        base_nlive = self.ns_kwargs.get("nlive", 100)
        nlive_pix = base_nlive + (
            self.nlive_snr_fact * np.nan_to_num(max_snr[pixel_ix])
        ).astype(int)
        nlive_assign, _ = bucket_nlive(nlive_pix,
                                       n_buckets=self.nlive_buckets)
        chunk = 0
        t_start = now_ns()
        for level in np.unique(nlive_assign):
            sel = pixel_ix[nlive_assign == level]
            cfg = NSConfig(**dict(self.ns_kwargs, nlive=int(level)))
            for lo in range(0, sel.size, self.batch_size):
                batch_ix = sel[lo:lo + self.batch_size]
                (b_ss,) = root.spawn(1)
                # the batch's records close before it is handed on: the
                # caller's work between batches is not the batch's
                with collect() as tr:
                    out = self._run_batch_with_retry(b_ss, batch_ix, datas,
                                                     noises, cfg, chunk)
                _log_batch(chunk, tr)
                if out is not None:
                    (nbest, records, rungs), attempts = out
                    yield BatchRecords(chunk=chunk, nlive=int(level),
                                       pixel_ix=batch_ix, nbest=nbest,
                                       records=records, rungs=rungs,
                                       attempts=attempts, trace=tr)
                chunk += 1
        log.info("fit_cube: fitting done in %.1fs",
                 (now_ns() - t_start) / 1e9)

    def fit_cube(self, store_name="run/test_cube", nproc=1, seed=0,
                 timeout=None, resume=False, host_shard=False,
                 process_id=None, process_count=None, link=True):
        """Fit the full field and write the store (needs ``h5py``).

        ``nproc`` and ``timeout`` are accepted for API parity and
        unused.  With ``resume=True`` pixels already in the store's
        completion manifest are skipped.  Returns the closed ``HdfStore``
        (None on a process other than 0).

        Multi-process: with ``host_shard=True`` each process fits its
        interleaved stripe of the valid pixels left after resume, from a
        seed stream of its own (:func:`host_share`), and writes its own
        ``chunk_h<process>_<j>.hdf`` files.  The process index and count
        are ``process_id``/``process_count`` or the ``torch.distributed``
        group's (``parallel.initialize_distributed``).  Only process 0
        opens ``table.hdf``: it writes the header, and after a barrier of
        the process group links every shard; without a group there is no
        barrier, and linking is left to the caller (``link`` is then
        False, with a warning).
        """
        from nestfit_tpu_torch.cube.store import HdfStore, check_ext, \
            completed_pixels, write_chunk

        n_lat = self.stack.spatial_shape[1]
        _, _, nan_mask, _ = self.stack.get_flat_batch()
        valid_ix = np.nonzero(~nan_mask)[0]
        pi, pc = host_rank(host_shard, process_id, process_count)
        nchunks = max(1, int(np.ceil(valid_ix.size / self.batch_size)))
        if pi == 0:
            store = HdfStore(store_name, nchunks=nchunks)
            store_dir = store.store_dir
        else:
            store = None
            store_dir = Path(check_ext(str(store_name), ext="store"))
            store_dir.mkdir(parents=True, exist_ok=True)
        if resume:
            done = completed_pixels(store_dir)
            valid_ix = np.setdiff1d(valid_ix, done)
            log.info("fit_cube: resume skips %d completed pixels", done.size)
        log.info("fit_cube: %d/%d valid pixels", valid_ix.size,
                 nan_mask.size)
        if store is not None:
            store.insert_header(self.stack)
            store.insert_fitter_pars(self)
            store.insert_model_metadata(self.runner_cls.model)
        for batch in self._fit_batches(seed, valid_ix, host_shard, pi, pc):
            path = store_dir / f"chunk_h{pi}_{batch.chunk}.hdf" \
                if host_shard else \
                store.chunk_paths[batch.chunk % store.nchunks]
            write_chunk(path, batch, n_lat)
        if host_shard and pc > 1 and not distributed.barrier():
            log.warning("no process group to wait on; link the chunk "
                        "shards once every process is done")
            link = False
        if store is not None:
            if link:
                store.link_files()
            store.close()
        return store
