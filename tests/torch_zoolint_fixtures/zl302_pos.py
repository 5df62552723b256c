import numpy as np


def predict(model, x):  # hot entry point by name
    return np.asarray(model.predict_fn(x))  # implicit device->host
