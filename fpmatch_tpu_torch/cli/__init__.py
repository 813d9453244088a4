"""Command-line entry points of the port."""

# channel widths of the ResNet-18 taps (backbone.node_taps): the
# node_feature_dim arithmetic lives here once
TAP_CHANNELS = {"layer1": 64, "layer2": 128, "layer3": 256}


def model_config_from_args(args):
    """Build the model Config of the serving CLI: shapes, grayscale
    shipping, node taps, cls_k_features, hyperedge, bf16."""
    import dataclasses

    from ..core.config import Config, ShapeConfig

    cfg = Config(shapes=ShapeConfig(n_max=args.n_max, e_max=args.e_max,
                                    univ_size=args.univ))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_channels=1))
    taps = tuple(args.node_taps.split(","))
    if taps != ("layer3",):
        feat = sum(TAP_CHANNELS[t] for t in taps) + 512
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, node_taps=taps),
            ngm=dataclasses.replace(cfg.ngm, node_feature_dim=feat))
    if getattr(args, "cls_k_features", False):
        cfg = dataclasses.replace(
            cfg, ngm=dataclasses.replace(cfg.ngm, cls_k_features=True))
    if getattr(args, "hyperedge", False):
        cfg = dataclasses.replace(
            cfg, ngm=dataclasses.replace(cfg.ngm, hyperedge=True))
    if getattr(args, "bf16", False):
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"),
            ngm=dataclasses.replace(cfg.ngm, compute_dtype="bfloat16"))
    return cfg
