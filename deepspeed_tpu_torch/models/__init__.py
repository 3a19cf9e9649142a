from .bert import BERT_CONFIGS, BertConfig, bert_apply, bert_init, \
    bert_mlm_loss_fn
from .gpt2 import GPT2_CONFIGS, GPT2Config, gpt2_apply, gpt2_init
from .transformer import TransformerConfig

__all__ = ["GPT2Config", "GPT2_CONFIGS", "gpt2_init", "gpt2_apply",
           "BertConfig", "BERT_CONFIGS", "bert_init", "bert_apply",
           "bert_mlm_loss_fn", "TransformerConfig"]
