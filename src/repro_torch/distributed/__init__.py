"""Expert-parallel execution over ``torch.distributed`` (port of
``repro/distributed``): the logical-axis sharding rules and the MoE
layer's expert-parallel paths.  ``collectives.py`` (the compressed
gradient all-reduce) comes with training on a mesh (ROADMAP A13b)."""
