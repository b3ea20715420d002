"""The ``cube`` entry: ``CubeFitter._fit_batches``, the store-free path
of ``fit_cube`` (the card's machine has no ``h5py``), at the
configuration's ladder settings, over a cube of one batch per unit.  A
unit is the next batch it yields."""

import contextlib

import numpy as np
import torch

from core import program


class Entry:
    """``CubeFitter._fit_batches`` over a cube that set-up made, one pass
    over it."""

    @staticmethod
    def pixels(config, traffic, n_units):
        """The cube holds one batch for each unit of the window."""
        return n_units * config["batch_size"]

    def __init__(self, config, inputs, seed_seq, device, tap):
        cube = program.modules()[0]
        self.config, self.inputs, self.device, self.tap = \
            config, inputs, device, tap
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
        self.n_batches = -(-n // config["batch_size"])
        self.seed = int(seed_seq.generate_state(1, np.uint64)[0]
                        >> np.uint64(1))
        self.gen = None
        self.expect = 0
        self.tapping = contextlib.ExitStack()
        self.tapping.enter_context(tap.on(program.fit_module_of_fitter()))

    def prepare(self):
        """The kernels' build, the linear-algebra library and one
        likelihood call at the batch width for every rung
        (``aot.compile_plan`` in the segmented mode), on runners made
        from the first batch through the public constructors."""
        _, _, _, aot, _, _, _ = program.modules()
        b = min(self.config["batch_size"], self.inputs.n_pix)
        r_pad = program.next_pow2(b)
        rows = np.resize(np.arange(b), r_pad)
        model = self.runner_cls.model
        spectra = tuple(
            model.make_model_spectrum(
                c.xarr, torch.as_tensor(d[rows], dtype=torch.float32,
                                        device=self.device),
                torch.as_tensor(nn[rows], dtype=torch.float32,
                                device=self.device),
                trans_id=c.trans_id, device=self.device)
            for c, d, nn in zip(self.fitter.stack.cubes, self.datas,
                                self.noises))
        cfg = program.ns_config(self.config)
        reports = []
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
        size = self.config["batch_size"]
        n = self.inputs.n_pix

        def px(lo, hi):
            return sum(min(size, n - c * size) for c in range(lo, hi))

        if b is None:
            # the pass is over; batches it never yielded failed
            lo, self.expect = self.expect, self.n_batches
            if lo >= self.n_batches:
                return None
            return dict(pixels=0, attempted=px(lo, self.n_batches),
                        failed=px(lo, self.n_batches), batch=None)
        failed = px(self.expect, b.chunk)
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
