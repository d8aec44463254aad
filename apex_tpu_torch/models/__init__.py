"""Models of the port: the ResNet family and BERT."""

from .bert import (BertConfig, BertForPretraining, BertModel, bert_base,
                   bert_large)
from .resnet import (BasicBlock, Bottleneck, ResNet, convert_stem_to_s2d,
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     stem_weight_to_s2d)

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "stem_weight_to_s2d",
           "convert_stem_to_s2d",
           "BertConfig", "BertModel", "BertForPretraining", "bert_base",
           "bert_large"]
