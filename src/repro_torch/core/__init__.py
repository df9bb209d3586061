"""FedLesScan core: client history, clustering, selection, aggregation."""
from .aggregation import (ClientUpdate, RunningAggregator, UpdateStore,
                          fedavg_aggregate, fedavg_coefficients,
                          flat_update_matrix, staleness_aggregate,
                          staleness_coefficients)
from .clustering import (ClusteringResult, calinski_harabasz,
                         calinski_harabasz_batch, cluster_clients, dbscan,
                         pairwise_sq_dists)
from .compress import SCHEMES, CompressionConfig, UpdateCompressor
from .device_batch import (DeviceUpdateBatch, pipeline_enabled,
                           reset_transfer_stats, transfer_stats)
from .features import (ema, ema_step, feature_matrix, missed_round_ema,
                       normalize01, total_ema, training_ema)
from .flatten import flatten_params, tree_leaves, tree_map
from .history import ClientHistoryDB, ClientRecord
from .merge import SERVER_OPTS, MergePipeline, ServerOptConfig
from .selection import SelectionPlan, select_clients, select_random
from .strategies import (STRATEGIES, FedAsync, FedAvg, FedBuff, FedLesScan,
                         FedProx, Strategy, StrategyConfig, make_strategy)

__all__ = [
    "ClientUpdate", "RunningAggregator", "UpdateStore", "fedavg_aggregate",
    "fedavg_coefficients", "flat_update_matrix", "staleness_aggregate",
    "staleness_coefficients", "ClusteringResult", "calinski_harabasz",
    "calinski_harabasz_batch", "cluster_clients", "dbscan",
    "pairwise_sq_dists", "SCHEMES", "CompressionConfig", "UpdateCompressor",
    "ema", "ema_step", "feature_matrix",
    "missed_round_ema", "normalize01", "total_ema", "training_ema",
    "flatten_params", "tree_leaves", "tree_map", "ClientHistoryDB",
    "ClientRecord", "SERVER_OPTS", "MergePipeline", "ServerOptConfig",
    "SelectionPlan", "select_clients", "select_random", "STRATEGIES",
    "FedAsync", "FedAvg", "FedBuff", "FedLesScan", "FedProx", "Strategy",
    "StrategyConfig", "make_strategy", "DeviceUpdateBatch",
    "pipeline_enabled", "transfer_stats", "reset_transfer_stats",
]
