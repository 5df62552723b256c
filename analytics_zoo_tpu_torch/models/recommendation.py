"""Recommendation models: the Recommender base, NeuralCF, WideAndDeep.

Counterpart of ``analytics_zoo_tpu/models/recommendation.py``: the
reference's graphs (an MLP tower with an optional matrix-factorisation
branch joined by concat; a wide sparse-linear part and a deep tower
joined by add, then log-softmax), built from the port's layers and
autograd ops in the JAX package's creation order, so layer names and
weights match it.  Lookups are embedding gathers, the towers Dense
layers.  Each model is built on ``device`` (``"cuda"`` unless asked
otherwise) from ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core.graph import Input
from ..pipeline.api import autograd as A
from ..pipeline.api.keras.engine import Model
from ..pipeline.api.keras.layers import Activation, Dense, Embedding
from .common import ZooModel, register_zoo_model


@dataclasses.dataclass
class UserItemFeature:
    """A (user id, item id) pair with its model input and label."""

    user_id: int
    item_id: int
    feature: object  # the model input: an array or a tuple of arrays
    label: Optional[int] = None


@dataclasses.dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


@dataclasses.dataclass
class ColumnFeatureInfo:
    """The reference's ColumnFeatureInfo: the columns of each part of a
    WideAndDeep input and their dimensions."""

    wide_base_cols: Sequence[str] = ()
    wide_base_dims: Sequence[int] = ()
    wide_cross_cols: Sequence[str] = ()
    wide_cross_dims: Sequence[int] = ()
    indicator_cols: Sequence[str] = ()
    indicator_dims: Sequence[int] = ()
    embed_cols: Sequence[str] = ()
    embed_in_dims: Sequence[int] = ()
    embed_out_dims: Sequence[int] = ()
    continuous_cols: Sequence[str] = ()
    label: str = "label"


def _by_probability(preds, key: str, limit: int) -> List[UserItemPrediction]:
    """The ``limit`` most probable predictions of each ``key`` (user_id
    or item_id), groups in order of first appearance."""
    groups = {}
    for pred in preds:
        groups.setdefault(getattr(pred, key), []).append(pred)
    out = []
    for rows in groups.values():
        rows.sort(key=lambda r: -r.probability)
        out.extend(rows[:limit])
    return out


class Recommender(ZooModel):
    """predict_user_item_pair, recommend_for_user and recommend_for_item
    over a model whose output is log-probabilities."""

    def predict_user_item_pair(self, feature_pairs: Sequence[UserItemFeature],
                               batch_size: int = 128
                               ) -> List[UserItemPrediction]:
        """Each pair's most probable class (1-based, as the reference)
        and its probability."""
        feats = [p.feature for p in feature_pairs]
        x = (tuple(np.stack([f[i] for f in feats])
                   for i in range(len(feats[0])))
             if isinstance(feats[0], (tuple, list)) else np.stack(feats))
        probs = np.exp(np.asarray(self.predict(x, batch_size=batch_size)))
        preds = np.argmax(probs, axis=-1)
        return [UserItemPrediction(p.user_id, p.item_id, int(c) + 1,
                                   float(pr[c]))
                for p, c, pr in zip(feature_pairs, preds, probs)]

    def recommend_for_user(self, feature_pairs: Sequence[UserItemFeature],
                           max_items: int) -> List[UserItemPrediction]:
        return _by_probability(self.predict_user_item_pair(feature_pairs),
                               "user_id", max_items)

    def recommend_for_item(self, feature_pairs: Sequence[UserItemFeature],
                           max_users: int) -> List[UserItemPrediction]:
        return _by_probability(self.predict_user_item_pair(feature_pairs),
                               "item_id", max_users)


@register_zoo_model
class NeuralCF(Recommender):
    """Neural Collaborative Filtering.

    Input: an int tensor (batch, 2) of 1-based [user_id, item_id].
    Output: log-softmax over ``num_classes``.
    """

    def __init__(self, user_count=None, item_count=None, num_classes=None,
                 user_embed=20, item_embed=20, hidden_layers=(40, 20, 10),
                 include_mf=True, mf_embed=20, name=None, device=None,
                 seed: int = 0, **kw):
        super().__init__(name=name, user_count=user_count,
                         item_count=item_count, num_classes=num_classes,
                         user_embed=user_embed, item_embed=item_embed,
                         hidden_layers=tuple(hidden_layers),
                         include_mf=include_mf, mf_embed=mf_embed, **kw)
        self.build_graph(device, seed)

    def build_model(self, device, seed: int) -> Model:
        h = self.hyper
        pair = Input((2,), name="pair_input")
        user = pair.index_select(1, 0)  # (batch,)
        item = pair.index_select(1, 1)
        # +1: ids are 1-based (the reference's LookupTable)
        mlp_user = Embedding(h["user_count"] + 1, h["user_embed"],
                             init="normal")(user)
        mlp_item = Embedding(h["item_count"] + 1, h["item_embed"],
                             init="normal")(item)
        merged = A.concat([mlp_user, mlp_item], axis=-1)
        for width in h["hidden_layers"]:
            merged = Dense(width, activation="relu")(merged)
        if h["include_mf"]:
            if h["mf_embed"] <= 0:
                raise ValueError(
                    "please provide meaningful number of embedding units")
            mf_user = Embedding(h["user_count"] + 1, h["mf_embed"],
                                init="normal")(user)
            mf_item = Embedding(h["item_count"] + 1, h["mf_embed"],
                                init="normal")(item)
            merged = A.concat([mf_user * mf_item, merged], axis=-1)
        logits = Dense(h["num_classes"])(merged)
        return Model(input=pair, output=Activation("log_softmax")(logits),
                     name="net", device=device, seed=seed)


_WIDE_AND_DEEP_DIMS = ("wide_base_dims", "wide_cross_dims", "indicator_dims",
                       "embed_in_dims", "embed_out_dims")


@register_zoo_model
class WideAndDeep(Recommender):
    """Wide & Deep, ``model_type`` "wide", "deep" or "wide_n_deep".

    Inputs (the reference's assembled tensors, ``recommendation_utils``):
      wide input: int ids (batch, n_wide_cols), each offset into the
                  concatenated wide space (base then cross columns);
      deep input: floats (batch, indicator_width + n_embed_cols +
                  n_continuous): multi-hot indicators, then the embed
                  ids, then the continuous values.
    Output: log-softmax over ``num_classes``.
    """

    def __init__(self, model_type="wide_n_deep", num_classes=None,
                 column_info: Optional[ColumnFeatureInfo] = None,
                 hidden_layers=(40, 20, 10), name=None, device=None,
                 seed: int = 0, **kw):
        if column_info is not None:
            # plain hyperparameters, so that the config is JSON
            ci = (ColumnFeatureInfo(**column_info)
                  if isinstance(column_info, dict) else column_info)
            kw.update({k: tuple(getattr(ci, k)) for k in _WIDE_AND_DEEP_DIMS})
            kw["n_continuous"] = len(ci.continuous_cols)
        for k in _WIDE_AND_DEEP_DIMS:
            kw.setdefault(k, ())
        kw.setdefault("n_continuous", 0)
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in kw.items()}
        super().__init__(name=name, model_type=model_type,
                         num_classes=num_classes,
                         hidden_layers=tuple(hidden_layers), **kw)
        self.build_graph(device, seed)

    def build_model(self, device, seed: int) -> Model:
        h = self.hyper
        num_classes = h["num_classes"]
        model_type = h["model_type"]
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"unknown type {model_type!r}")
        indicator_width = sum(h["indicator_dims"])
        n_embed = len(h["embed_in_dims"])
        n_cont = h["n_continuous"]
        inputs, wide_out, deep_out = [], None, None

        if model_type in ("wide", "wide_n_deep"):
            n_wide_cols = len(h["wide_base_dims"]) + len(h["wide_cross_dims"])
            wide_total = sum(h["wide_base_dims"]) + sum(h["wide_cross_dims"])
            wide_in = Input((n_wide_cols,), name="wide_input")
            inputs.append(wide_in)
            # sparse linear: the sum of one-hot(id) @ W is the sum of the
            # embedding rows (the reference's LookupTableSparse, zero
            # init, plus a bias)
            wide_embed = Embedding(wide_total + 1, num_classes,
                                   init="zero")(wide_in)
            wide_sum = A.sum(wide_embed, axis=1)  # (batch, num_classes)
            bias = A.Parameter((num_classes,), init_method="zero",
                               name="wide_bias")
            wide_out = wide_sum + bias

        if model_type in ("deep", "wide_n_deep"):
            deep_in = Input((indicator_width + n_embed + n_cont,),
                            name="deep_input")
            inputs.append(deep_in)
            parts = []
            if indicator_width:
                parts.append(deep_in.slice(1, 0, indicator_width))
            for i, (in_dim, out_dim) in enumerate(
                    zip(h["embed_in_dims"], h["embed_out_dims"])):
                ids = deep_in.index_select(1, indicator_width + i)
                parts.append(Embedding(in_dim + 1, out_dim,
                                       init="normal")(ids))
            if n_cont:
                parts.append(deep_in.slice(
                    1, indicator_width + n_embed, n_cont))
            deep = parts[0] if len(parts) == 1 else A.concat(parts, axis=-1)
            for width in h["hidden_layers"]:
                deep = Dense(width, activation="relu")(deep)
            deep_out = Dense(num_classes)(deep)

        logits = (wide_out + deep_out if model_type == "wide_n_deep"
                  else wide_out if model_type == "wide" else deep_out)
        return Model(input=inputs if len(inputs) > 1 else inputs[0],
                     output=Activation("log_softmax")(logits), name="net",
                     device=device, seed=seed)
