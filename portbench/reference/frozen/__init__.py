"""A frozen copy of the composed StyleGAN2 path of ``gagan_tpu_torch``,
cut to what the benchmark's plain reference runs: the models, the composed
ops, the ADA pipe, the losses, the train step, the offsets and the
td_single adaptation trainer, as they stood when the benchmark was
written.

The reference runs these modules in float32 (TF32 off), and the control
one precision below (``ops/conv2d_gradfix.py``'s rounding), on inputs and
weights that the benchmark makes itself.  Nothing here imports the package
under test, so a later change to the package cannot change what it is
compared against.

Edits against the package's files, besides the paths cut away (the fused
level, the packed blocks, conditioning, truncation, the distributed paths,
the other trainers, losses and augment branches):

* ``utils/checkpoint.py`` keeps only ``tree_to_flat_tensors`` and
  ``tree_to_device``.
* ``ops/conv2d_gradfix.py`` carries the control's rounding (``Rounding``,
  ``control_rounding``), and the models' ``fp8_resolution``.
* ``models/stylegan2.py``'s ``_normal`` and ``clip/model.py``'s random
  init draw on the generator's own device, so that the benchmark can draw
  weights on the card.
"""
