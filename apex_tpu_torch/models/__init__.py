"""Models of the port: the ResNet family and BERT."""

from .bert import (BertConfig, BertForPretraining, BertModel, bert_base,
                   bert_large)
from .resnet import BasicBlock, Bottleneck, ResNet, resnet18, resnet50

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet50",
           "BertConfig", "BertModel", "BertForPretraining", "bert_base",
           "bert_large"]
