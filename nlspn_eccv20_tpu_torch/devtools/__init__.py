"""The port's counterparts of the JAX package's ``devtools/`` prototypes
that reach a TPU kernel.

* ``exp_deform_prop_kernel``: the windowed deformable gather (K10a,
  ``csrc/deform_windowed.cu``) and ``propagate_deformable_pallas``, its
  differentiable drop-in, whose backward is K8.
* ``exp_deform3``: the column-exact, row-windowed gather (K10b,
  ``csrc/deform_colgather.cu``), 3x3 only, forward only; ``main()`` times it
  beside the plain windowed form and K7.
* ``exp_deform2``: the gather probe (K10c, ``csrc/gather_probe.cu``) and the
  plain windowed prototype; ``main()`` runs the probe, then times the
  prototype forward and forward plus backward.
* ``microbench_interleave``: the output-driven 4x4 phase interleave (K11a,
  ``csrc/interleave_asm.cu``), the plain layout changes around it and
  deconv0 in NCHW and channels-last; ``main()`` times each.
* ``microbench_asm``: the input-driven interleave (K11b,
  ``csrc/interleave_strided.cu``), the blockwise-tile probe (K11c,
  ``csrc/tile_repeat_probe.cu``) and the interleave as a one-hot GEMM (K11d,
  ``csrc/interleave_onehot.cu``); ``main()`` checks and times the three.
* ``measure``: CUDA-event timing of CUDA-graph replays.

No module here has parameters, so none needs a weight bridge. The entry
points run on the card, and raise without one unless the caller passes
CPU tensors or ``device="cpu"``; on CPU tensors every kernel wrapper runs
its plain PyTorch version.
"""
