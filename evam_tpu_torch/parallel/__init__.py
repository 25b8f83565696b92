"""The parallel training path (counterpart of ``evam_tpu/parallel``):
process meshes over ``torch.distributed`` (``mesh``), the exchanges as
autograd functions (``comm``), ring and Ulysses sequence parallelism
(``ring``, ``ulysses``), the mixture-of-experts MLP (``moe``), the dp ×
sp × tp trainer of the action recognizer (``train``), GPipe stages
(``pipeline``) and the multi-rank dry run (``dryrun``). No module here
holds a kernel: the reference's ``shard_map`` bodies are plain ``jnp``,
so these are plain torch.
"""
