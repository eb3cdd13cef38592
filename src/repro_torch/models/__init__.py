"""Models of the port: the dense decoder's layers and assembly, the CNN and
the ViT, and ``build_model_for``, the family dispatch of
``repro/models/__init__.py``."""


def build_model_for(arch, params=None, *, pp_stages: int = 1,
                    pp_microbatches: int = 0, mesh=None, **kwargs):
    """The model of ``arch``'s family: ``transformer.Model`` for the dense
    decoder (with its pipeline knobs ``pp_stages`` and
    ``pp_microbatches``), ``cnn.CNNModel`` for ``"cnn"``, ``vit.ViTModel``
    for ``"vit"``; ``kwargs`` as those take them.  ``mesh``: a
    data-parallel run's mesh, on which a ``use_fsdp`` decoder's params are
    FSDP-sharded (``transformer.Model``).  The image families have
    no repeated-block axis to cut into stages: a ``pp_stages`` above 1
    raises for them."""
    if arch.family in ("cnn", "vit"):
        if pp_stages > 1:
            raise ValueError(
                f"pp_stages={pp_stages} is only supported for transformer "
                f"families (scan-stacked blocks); arch {arch.name!r} is "
                f"family {arch.family!r}")
        if arch.family == "cnn":
            from repro_torch.models.cnn import CNNModel
            return CNNModel(arch, params, **kwargs)
        from repro_torch.models.vit import ViTModel
        return ViTModel(arch, params, **kwargs)
    from repro_torch.models.transformer import Model
    return Model(arch, params, pp_stages=pp_stages,
                 pp_microbatches=pp_microbatches, mesh=mesh, **kwargs)
