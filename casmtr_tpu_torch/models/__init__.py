def build_model(loftr_config, refine: bool = False):
    """Model factory, as the JAX package's: CasMTR when ``cascade`` is set,
    else the plain QuadtreeLoFTR; ``refine`` (the PMT-refine assembly) waits
    in ROADMAP queue A."""
    if refine:
        raise NotImplementedError(
            "the PMT-refine assembly is not ported yet (ROADMAP queue A: "
            "PMT refine)")
    if loftr_config.cascade:
        from casmtr_tpu_torch.models.casmtr import CasMTR
        return CasMTR(loftr_config)
    from casmtr_tpu_torch.models.loftr import QuadtreeLoFTR
    return QuadtreeLoFTR(loftr_config)
