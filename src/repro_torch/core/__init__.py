"""Core retrieval modules: distances, engine, builders, index, spec, metrics,
tuning, learned construction distances and the runtime checks."""

from repro_torch.core.distances import (
    Distance,
    apply_post,
    available_distances,
    get_distance,
    itakura_saito,
    kl_divergence,
    l2_squared,
    neg_inner_product,
    renyi_divergence,
)
from repro_torch.core.symmetrize import (
    SYM_MODES,
    CombinedDistance,
    LearnedDistance,
    ReversedDistance,
    SymmetrizedDistance,
    ViewedDistance,
    calibrate_tau,
    get_learned_weights,
    learned_weights_fingerprint,
    register_learned_weights,
    symmetrized,
)
from repro_torch.core.spec import (
    LEARNED_ARTIFACT_KIND,
    TUNED_ARTIFACT_KIND,
    Blend,
    DistancePolicy,
    Learned,
    MaxSym,
    RankBlend,
    RetrievalSpec,
    dominates,
    learned_artifact,
    load_learned_artifact,
    load_spec,
    load_tuned_artifact,
    pareto_frontier,
    tuned_artifact,
)
from repro_torch.core.brute_force import ground_truth, knn_scan
from repro_torch.core.beam_search import beam_search_impl, make_batched_searcher
from repro_torch.core.batched_beam import (
    BatchBeamState,
    batched_beam_search,
    beam_step,
    make_step_searcher,
    seed_beams,
    select_entries,
)
from repro_torch.core.scheduler import GraphView, SlotResult, SlotScheduler
from repro_torch.core.distributed import (
    ShardedSlotScheduler,
    build_local_subgraphs,
    pad_to_shards,
    sharded_graph_search,
    sharded_knn_scan,
)
from repro_torch.core.swgraph import build_swgraph
from repro_torch.core.build_engine import build_sharded, build_swgraph_wave, reverse_edge_merge
from repro_torch.core.nndescent import build_nndescent
from repro_torch.core.online import OnlineIndex
from repro_torch.core.filter_refine import filter_and_refine, kc_sweep, rerank
from repro_torch.core.index import ANNIndex
from repro_torch.core.autotune import (
    Candidate,
    TuneDraws,
    TuneResult,
    autotune,
    build_cost_proxy,
    default_axes,
)
from repro_torch.core.metric_learning import (
    MahalanobisDraws,
    draw_mahalanobis,
    fit_mahalanobis_map,
    l2_proxy,
    learn_mahalanobis,
    true_neighbor_ids,
)
from repro_torch.core.learned import (
    LearnedResult,
    LearnedTerms,
    fit_construction_distance,
    learned_terms,
    mahalanobis_weights,
)
from repro_torch.core.metrics import order_aware_recall, recall_at_k, speedup_model
from repro_torch.core.runtime_checks import (
    RecompileError,
    disable_strict_mode,
    dispatch_cache_size,
    enable_strict_mode,
    recompile_guard,
    strict_mode_requested,
)

__all__ = [
    "ANNIndex", "BatchBeamState", "Blend", "Candidate", "CombinedDistance", "Distance",
    "DistancePolicy", "GraphView", "LEARNED_ARTIFACT_KIND", "Learned", "LearnedDistance",
    "LearnedResult", "LearnedTerms", "MahalanobisDraws", "MaxSym", "OnlineIndex",
    "RankBlend", "RecompileError", "RetrievalSpec", "ReversedDistance", "SYM_MODES",
    "ShardedSlotScheduler", "SlotResult", "SlotScheduler", "SymmetrizedDistance",
    "TUNED_ARTIFACT_KIND", "TuneDraws", "TuneResult", "ViewedDistance", "apply_post",
    "autotune", "available_distances", "batched_beam_search", "beam_search_impl",
    "beam_step", "build_cost_proxy", "build_local_subgraphs", "build_nndescent",
    "build_sharded", "build_swgraph", "build_swgraph_wave", "calibrate_tau", "default_axes",
    "disable_strict_mode", "dispatch_cache_size", "dominates", "draw_mahalanobis",
    "enable_strict_mode", "filter_and_refine", "fit_construction_distance",
    "fit_mahalanobis_map", "get_distance", "get_learned_weights", "ground_truth",
    "itakura_saito", "kc_sweep", "kl_divergence", "knn_scan", "l2_proxy", "l2_squared",
    "learn_mahalanobis", "learned_artifact", "learned_terms", "learned_weights_fingerprint",
    "load_learned_artifact", "load_spec", "load_tuned_artifact", "mahalanobis_weights",
    "make_batched_searcher", "make_step_searcher", "neg_inner_product",
    "order_aware_recall", "pad_to_shards", "pareto_frontier", "recall_at_k",
    "recompile_guard", "register_learned_weights", "renyi_divergence", "rerank",
    "reverse_edge_merge", "seed_beams", "select_entries", "sharded_graph_search",
    "sharded_knn_scan", "speedup_model", "strict_mode_requested", "symmetrized",
    "true_neighbor_ids", "tuned_artifact"
]
