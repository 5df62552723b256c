"""ONNX import (reference: pyzoo/zoo/pipeline/api/onnx/); the counterpart
of ``analytics_zoo_tpu/pipeline/api/onnx``, with no ``onnx`` package."""

from .onnx_loader import OnnxLoader, OnnxNet, load_onnx
from .converter import OnnxGraph
from . import proto

__all__ = ["OnnxLoader", "OnnxNet", "load_onnx", "OnnxGraph", "proto"]
