"""Models of the port: the dense decoder's layers and assembly, the CNN and
the ViT, and ``build_model_for``, the family dispatch of
``repro/models/__init__.py``."""


def build_model_for(arch, params=None, *, pp_stages: int = 1, **kwargs):
    """The model of ``arch``'s family: ``transformer.Model`` for the dense
    decoder, ``cnn.CNNModel`` for ``"cnn"``, ``vit.ViTModel`` for ``"vit"``;
    ``kwargs`` as those take them.  Pipeline stages are not ported, and the
    image families have no repeated-block axis to cut into stages: a
    ``pp_stages`` above 1 raises for every family."""
    if pp_stages > 1:
        if arch.family in ("cnn", "vit"):
            raise ValueError(
                f"pp_stages={pp_stages} is only supported for transformer "
                f"families (scan-stacked blocks); arch {arch.name!r} is "
                f"family {arch.family!r}")
        raise NotImplementedError("pipeline stages are not ported yet "
                                  "(ROADMAP queue 1)")
    if arch.family == "cnn":
        from repro_torch.models.cnn import CNNModel
        return CNNModel(arch, params, **kwargs)
    if arch.family == "vit":
        from repro_torch.models.vit import ViTModel
        return ViTModel(arch, params, **kwargs)
    from repro_torch.models.transformer import Model
    return Model(arch, params, **kwargs)
