"""The paper's figure drivers and the measurement drivers on the port
(counterparts of ``experiments/figure{1,2,3,4}.py``, ``common.py``,
``plotting.py``, ``scale_demo.py``, ``steady_decay_probe.py``,
``steady_error_probe.py`` and ``tpu_work_precision.py``).

Each figure driver runs as ``python -m pnmol_tpu_torch.experiments.figureN
[--fast] [--no-plot] [--device cuda|cpu] [--out DIR]`` and exposes
``run(device, *, fast=False, ...)``, which returns its arrays under the
JAX drivers' names. matplotlib is imported only by :mod:`plotting`, and
only when a figure is rendered. The measurement drivers
(:mod:`scale_demo`, :mod:`steady_decay_probe`, :mod:`steady_error_probe`,
:mod:`work_precision`) print the JAX drivers' JSON records and write them
under ``chiprun_out/<driver>/``, never into the JAX package's committed
records.
"""
