"""The reference-oracle harness of the port (``geopurify-torch-parity
--torch-oracle``).

Port of geopurify_tpu/parity/. Every numerical-parity question
(bicubic antialias semantics, /32 padding, attention-mask thresholds,
prompt averaging, converter layout) is settled by instantiating the
reference torch modules with seeded random weights on the CPU, converting
their state dicts through the port's converters, and diffing the port's
activations stage by stage, its side on the card or the CPU.

- shims:         stand-ins for the reference's absent heavy dependencies
                 (detectron2 / timm / fvcore / kornia / mpi4py, faiss,
                 torch_scatter, MinkowskiEngine), installed only when a stage
                 that needs the reference runs;
- oracle:        builders that import the mounted reference modules and
                 return (activations, state dict) for each stage;
- sonata_oracle: a naive-loop numpy Sonata, which needs no reference;
- compare:       the port's side of each stage and ``run_all``.

Run: python -m geopurify_tpu_torch.run.parity --torch-oracle small [--stages sonata]
"""
