from .serving import ServingAggregator, percentile
from .serving_slo import SERVING_BUCKETS, ServingGoodputLedger, SLOTracker

__all__ = ["ServingAggregator", "percentile", "SERVING_BUCKETS",
           "ServingGoodputLedger", "SLOTracker"]
