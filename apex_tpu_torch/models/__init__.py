"""Models of the port: the ResNet family, BERT, the decoder families
(GPT-2; Llama with its Mistral, Qwen2, Gemma and GPT-NeoX knobs; Mixtral),
the T5 encoder-decoder, beam search and speculative decoding, and the
DCGAN generator and discriminator."""

from .dcgan import Discriminator, Generator, dcgan
from .bert import (BertConfig, BertForPretraining, BertModel, bert_base,
                   bert_large)
from .gpt import GPT, GPTConfig, gpt2_medium, gpt2_small
from .llama import Llama, LlamaConfig, RMSNorm, llama_params_to_tp
from .mixtral import Mixtral, MixtralBlock, MixtralConfig
from .speculative import generate_speculative
from .beam import beam_search
from .t5 import T5, T5Config
from .resnet import (BasicBlock, Bottleneck, ResNet, convert_stem_to_s2d,
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     stem_weight_to_s2d)

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "stem_weight_to_s2d",
           "convert_stem_to_s2d",
           "BertConfig", "BertModel", "BertForPretraining", "bert_base",
           "bert_large", "GPTConfig", "GPT", "gpt2_small", "gpt2_medium",
           "LlamaConfig", "Llama", "RMSNorm", "llama_params_to_tp",
           "MixtralConfig", "MixtralBlock", "Mixtral", "generate_speculative",
           "beam_search", "T5Config", "T5", "Generator", "Discriminator",
           "dcgan"]
