def build_model(loftr_config):
    """Model factory: CasMTR-4c and CasMTR-2c (the assemblies ported so far;
    the plain QuadtreeLoFTR and PMT refine wait in ROADMAP queue A)."""
    if not loftr_config.cascade:
        raise NotImplementedError(
            "QuadtreeLoFTR (cascade=False) is not ported yet (ROADMAP queue "
            "A: QuadtreeLoFTR)")
    from casmtr_tpu_torch.models.casmtr import CasMTR
    return CasMTR(loftr_config)
