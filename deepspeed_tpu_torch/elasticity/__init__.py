from .elasticity import (compute_elastic_config, elasticity_enabled,
                         get_candidate_batch_sizes, get_valid_gpus,
                         get_best_candidates, HCN_LIST)
from .config import (ElasticityConfig, ElasticityError, ElasticityConfigError,
                     ElasticityIncompatibleWorldSize)
