"""The ``batch`` entry: ``fit_batch`` at its defaults (the traced mode,
CUDA graphs), rung 1 then rung 2 on every pixel of one runner per rung.
A unit is both rungs, with generators drawn afresh."""

import numpy as np
import torch

from core import program


class Entry:
    """``fit_batch`` at its defaults, rung 1 then rung 2 on every pixel
    of one runner per rung; each unit draws new generators."""

    @staticmethod
    def pixels(config, traffic, n_units):
        """Every unit fits the same ``traffic["pixels"]``."""
        return int(traffic["pixels"])

    def __init__(self, config, inputs, seed_seq, device, tap):
        self.config, self.inputs, self.device, self.tap = \
            config, inputs, device, tap
        runner_cls, utrans = program.runner_parts(config, device)
        model = runner_cls.model
        spectra = tuple(
            model.make_model_spectrum(xarr, d, np.full(d.shape[0],
                                                       inputs.rms),
                                      trans_id=tid, device=device)
            for tid, xarr, d in inputs.spectra)
        self.runners = [runner_cls(spectra, utrans, ncomp=n, device=device)
                        for n in range(1, config["ncomp_max"] + 1)]
        self.cfg = program.ns_config(config)
        self.seeds = seed_seq

    def prepare(self):
        """``aot.compile_plan`` of both rungs in the traced mode: the
        build, the warm-up block and every graph the run replays."""
        _, _, _, aot, _, _, _ = program.modules()
        return [aot.compile_plan(aot.build_plan(
            r, self.inputs.n_pix, self.cfg, segment_iters=0,
            device=self.device)) for r in self.runners]

    def unit(self, k):
        _, _, _, _, fit, graphs, _ = program.modules()
        self.tap.unit = k
        n = self.inputs.n_pix
        rungs = []
        for runner, ss in zip(self.runners, self.seeds.spawn(
                len(self.runners))):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]
                                >> np.uint64(1)))
            with self.tap.span(f"fit_batch ncomp={runner.ncomp} rows={n}"):
                out = fit.fit_batch(gen, runner, n, self.cfg,
                                    device=self.device)
            self.tap.take(out, np.arange(n), np.arange(n), self.cfg)
            st = graphs.last_stats
            rungs.append(dict(ncomp=runner.ncomp, ncall_mean=float(
                self.tap.runs[-1]["ncall"].astype(np.float64).mean()),
                blocks=st.blocks, straggler_blocks=st.straggler_blocks,
                captures=st.captures, warmups=st.warmups))
            del out
        return dict(pixels=n, attempted=n, failed=0, rungs=rungs)

    def close(self):
        _, _, _, _, _, graphs, _ = program.modules()
        self.runners = None
        graphs.clear()
