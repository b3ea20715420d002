"""The ``cube`` entry: ``CubeFitter._fit_batches``, the store-free path
of ``fit_cube`` (the card's machine has no ``h5py``), at the
configuration's ladder settings, over a cube of the traffic mix's
``map_px`` pixels (one batch for each unit of the window when the mix
names none).  A unit is the next batch it yields, and the window holds
exactly one pass: set-up makes the SNR bucket plan of the cube
(``reference/levels.py``), and stops unless the plan's batches are as
many as the window's units.  Pixels attempted and failed are counted
from the plan's batches."""

import contextlib

import numpy as np
import torch

from core import program
from reference import levels


class Entry:
    """``CubeFitter._fit_batches`` over a cube that set-up made, one pass
    over it."""

    n_units = None      # the window's units, as ``pixels`` was told them

    @classmethod
    def pixels(cls, config, traffic, n_units):
        """The mix's ``map_px``, or one batch for each unit of the
        window; the units are kept for set-up to hold the plan
        against."""
        cls.n_units = n_units
        return int(traffic.get("map_px", n_units * config["batch_size"]))

    def __init__(self, config, inputs, seed_seq, device, tap):
        cube = program.modules()[0]
        self.config, self.inputs, self.device, self.tap = \
            config, inputs, device, tap
        self.plan = levels.plan(config, [d for _, _, d in inputs.spectra],
                                inputs.rms)
        if len(self.plan.batches) != self.n_units:
            raise ValueError(
                f"the SNR bucket plan of this cube has "
                f"{len(self.plan.batches)} batches "
                f"({[(lv, ids.size) for lv, ids in self.plan.batches]}) "
                f"and the window {self.n_units} units: set the mix's "
                "unit_s so that the window holds exactly one pass")
        self.runner_cls, self.utrans = program.runner_parts(config, device)
        n = inputs.n_pix
        shape = (n // 32, 32) if n % 32 == 0 else (n, 1)
        stack = cube.CubeStack([
            cube.DataCube(d.reshape(*shape, -1), xarr,
                          noise_map=inputs.rms, trans_id=tid)
            for tid, xarr, d in inputs.spectra])
        self.fitter = cube.CubeFitter(
            stack, self.utrans, self.runner_cls,
            ns_kwargs=dict(nlive=config["nlive"], tol=config["tol"],
                           init_factor=config["init_factor"],
                           max_iter=config.get("max_iter", 0)),
            lnZ_thresh=config["lnZ_thresh"], ncomp_max=config["ncomp_max"],
            nlive_snr_fact=config["nlive_snr_fact"],
            nlive_buckets=config["nlive_buckets"],
            batch_size=config["batch_size"],
            segment_iters=config["segment_iters"],
            max_retries=config["max_retries"],
            mode_loss_margin=config["mode_loss_margin"],
            mode_loss_retries=config["mode_loss_retries"],
            boundary_band=config["boundary_band"],
            boundary_nlive_mult=config["boundary_nlive_mult"],
            device=device)
        self.datas, self.noises, _, _ = stack.get_flat_batch()
        tap.know_pixels(self.datas[0])
        self.seed = int(seed_seq.generate_state(1, np.uint64)[0]
                        >> np.uint64(1))
        self.gen = None
        self.expect = 0
        self.tapping = contextlib.ExitStack()
        self.tapping.enter_context(tap.on(program.fit_module_of_fitter()))

    def prepare(self):
        """The kernels' build, the linear-algebra library and one
        likelihood call for every rung at each level of the plan, at its
        live count and its first batch's padded width
        (``aot.compile_plan`` in the segmented mode), on runners made
        from that batch through the public constructors."""
        aot = program.modules()[3]
        model = self.runner_cls.model
        reports = []
        for level, ids in self.plan.first_batches():
            r_pad = program.next_pow2(ids.size)
            rows = np.resize(ids, r_pad)
            spectra = tuple(
                model.make_model_spectrum(
                    c.xarr, torch.as_tensor(d[rows], dtype=torch.float32,
                                            device=self.device),
                    torch.as_tensor(nn[rows], dtype=torch.float32,
                                    device=self.device),
                    trans_id=c.trans_id, device=self.device)
                for c, d, nn in zip(self.fitter.stack.cubes, self.datas,
                                    self.noises))
            cfg = program.ns_config(dict(self.config, nlive=level))
            for ncomp in range(1, self.config["ncomp_max"] + 1):
                runner = self.runner_cls(spectra, self.utrans, ncomp=ncomp,
                                         device=self.device)
                reports.append(aot.compile_plan(aot.build_plan(
                    runner, r_pad, cfg, segment_iters=self.config[
                        "segment_iters"], device=self.device)))
        return reports

    def unit(self, k):
        if self.gen is None:
            self.gen = iter(self.fitter._fit_batches(seed=self.seed))
        self.tap.unit = k
        b = next(self.gen, None)
        sizes = self.plan.sizes
        if b is None:
            # the pass is over; batches it never yielded failed
            lo, self.expect = self.expect, len(sizes)
            if lo >= len(sizes):
                return None
            return dict(pixels=0, attempted=sum(sizes[lo:]),
                        failed=sum(sizes[lo:]), batch=None)
        failed = sum(sizes[self.expect:b.chunk])
        self.expect = b.chunk + 1
        return dict(pixels=int(b.pixel_ix.size),
                    attempted=failed + int(b.pixel_ix.size), failed=failed,
                    batch=b)

    def close(self):
        _, _, _, _, _, graphs, _ = program.modules()
        self.tapping.close()
        self.gen = None
        self.fitter = None
        graphs.clear()
