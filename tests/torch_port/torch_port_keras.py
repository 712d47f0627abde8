"""Keras models and schedules that the Keras estimator tests hand to both
packages' ``KerasEstimator`` (``tests/test_spark_ray.py``'s, with the
parity model's initial weights set from a seeded numpy stream).  keras is
imported inside the functions, so the module loads on either backend, and
the train tasks unpickle them by name."""


def mlp_model_fn():
    """A 3-8-1 tanh MLP whose weights come from ``RandomState(7)``, so both
    backends start from the same model."""
    import keras
    import numpy as np
    model = keras.Sequential([keras.Input((3,)),
                              keras.layers.Dense(8, activation="tanh"),
                              keras.layers.Dense(1)])
    rng = np.random.RandomState(7)
    model.set_weights([0.5 * rng.randn(*w.shape).astype("float32")
                       for w in model.get_weights()])
    return model


def dense_model_fn():
    import keras
    return keras.Sequential([keras.Input((3,)), keras.layers.Dense(1)])


def freeze_after_first_epoch(epoch, lr):
    """A module-level schedule (picklable for the spawned tasks)."""
    return 0.0 if epoch >= 1 else lr


def make_data(n=96, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3)
    return {"features": x, "label": np.tanh(x @ np.ones((3, 1)))}
