def build_model(loftr_config, refine: bool = False):
    """Model factory, as the JAX package's: with ``refine`` the PMT-refine
    assembly CasMTRRefine (frozen quadtree trunk, ladder, ``cas_`` heads),
    else CasMTR when ``cascade`` is set and the plain QuadtreeLoFTR
    otherwise."""
    if refine:
        from casmtr_tpu_torch.models.casmtr_refine import CasMTRRefine
        return CasMTRRefine(loftr_config)
    if loftr_config.cascade:
        from casmtr_tpu_torch.models.casmtr import CasMTR
        return CasMTR(loftr_config)
    from casmtr_tpu_torch.models.loftr import QuadtreeLoFTR
    return QuadtreeLoFTR(loftr_config)
