"""Time-series anomaly detection with an LSTM forecaster, on the
PyTorch/CUDA port.

The port of ``anomaly_detection.py`` beside it (the reference's
apps/anomaly-detection/anomaly-detection-nyc-taxi.ipynb): train an LSTM
on sliding windows, forecast one step ahead, flag anomalies where the
residual exceeds a quantile threshold.  Runs on ``--device`` (default
``cuda``; ``--device cpu`` without a card).

REAL DATA: pass ``--data /path/to/nyc_taxi.csv`` — the Numenta Anomaly
Benchmark series (10 320 half-hourly taxi counts, Jul 2014 - Jan 2015,
``timestamp,value`` CSV with a header row), scored against NAB's five
labeled anomaly windows.  Without ``--data`` a synthetic series with the
same structure (daily + weekly seasonality, injected anomalies) keeps
the app runnable to a metric anywhere.
"""

import argparse
import csv
import datetime as dt

import numpy as np

# NAB combined_windows for realKnownCause/nyc_taxi.csv (published labels)
NAB_ANOMALY_WINDOWS = [
    ("2014-10-30 15:30:00", "2014-11-03 22:30:00"),   # NYC marathon
    ("2014-11-25 12:00:00", "2014-11-29 19:00:00"),   # Thanksgiving
    ("2014-12-23 11:30:00", "2014-12-27 18:30:00"),   # Christmas
    ("2014-12-29 21:30:00", "2015-01-03 04:30:00"),   # New Year
    ("2015-01-24 20:30:00", "2015-01-29 03:30:00"),   # blizzard
]


def load_nyc_taxi(path):
    """Parse the NAB ``timestamp,value`` CSV.  Returns (series f32,
    timestamps list[datetime])."""
    ts, vals = [], []
    with open(path) as fh:
        for row in csv.reader(fh):
            if not row or row[0] == "timestamp":
                continue
            ts.append(dt.datetime.strptime(row[0], "%Y-%m-%d %H:%M:%S"))
            vals.append(float(row[1]))
    if not vals:
        raise ValueError(f"no rows parsed from {path}")
    return np.asarray(vals, np.float32), ts


def nab_truth_mask(timestamps):
    """Boolean mask: timestamp falls inside a labeled anomaly window."""
    windows = [(dt.datetime.strptime(a, "%Y-%m-%d %H:%M:%S"),
                dt.datetime.strptime(b, "%Y-%m-%d %H:%M:%S"))
               for a, b in NAB_ANOMALY_WINDOWS]
    return np.array([any(a <= t <= b for a, b in windows)
                     for t in timestamps])


def make_series(n=2000, seed=0):
    """Synthetic 'taxi traffic': daily + weekly periodicity + noise,
    with injected anomalies."""
    rs = np.random.RandomState(seed)
    t = np.arange(n)
    series = (10 + 4 * np.sin(2 * np.pi * t / 48)
              + 2 * np.sin(2 * np.pi * t / (48 * 7))
              + 0.4 * rs.randn(n))
    anomaly_idx = rs.choice(n // 2, 8, replace=False) + n // 2
    series[anomaly_idx] += rs.choice([-6, 6], 8)
    truth = np.zeros(n, bool)
    truth[anomaly_idx] = True
    return series.astype(np.float32), truth


def windows(series, lookback):
    x = np.stack([series[i:i + lookback]
                  for i in range(len(series) - lookback)])
    y = series[lookback:]
    return x[..., None], y[:, None]


def build_model(lookback, device):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
        Dense, Dropout)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.recurrent import (
        LSTM)

    model = Sequential(name="anomaly_lstm", device=device)
    model.add(LSTM(32, input_shape=(lookback, 1)))
    model.add(Dropout(0.2))
    model.add(Dense(1))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    help="NAB nyc_taxi.csv; synthetic fallback if omitted")
    ap.add_argument("--lookback", type=int, default=24,
                    help="forecast window; raised to >=48 (one day of "
                         "half-hours) with --data unless already larger")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--quantile", type=float, default=0.995)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)

    if args.data:
        series, ts = load_nyc_taxi(args.data)
        truth = nab_truth_mask(ts)
        if args.lookback < 48:
            print(f"note: raising --lookback {args.lookback} -> 48 "
                  "(one day of half-hourly points)")
            args.lookback = 48
        print(f"loaded NYC taxi: {len(series)} points, "
              f"{truth.sum()} labeled-anomalous points in "
              f"{len(NAB_ANOMALY_WINDOWS)} windows")
    else:
        series, truth = make_series()
        print("synthetic fallback (pass --data for NAB nyc_taxi.csv)")

    mean, std = series.mean(), series.std()
    normed = (series - mean) / std
    x, y = windows(normed, args.lookback)
    split = len(x) // 2
    x_train, y_train = x[:split], y[:split]
    x_test, y_test = x[split:], y[split:]

    model = build_model(args.lookback, args.device)
    model.compile(optimizer="adam", loss="mean_squared_error")
    model.fit(x_train, y_train, batch_size=64, nb_epoch=args.epochs)

    pred = np.asarray(model.predict(x_test, batch_size=64))
    resid = np.abs(pred - y_test).ravel()
    threshold = np.quantile(resid, args.quantile)
    flagged_rel = np.nonzero(resid > threshold)[0]
    # map window index back to the flagged point's series position
    flagged_idx = flagged_rel + split + args.lookback

    test_truth = truth.copy()
    test_truth[:split + args.lookback] = False
    if args.data:
        # score against the labeled WINDOWS: a window counts as detected
        # if any flagged point falls inside it; precision = flagged
        # points that land in some window
        detected = 0
        win = [(dt.datetime.strptime(a, "%Y-%m-%d %H:%M:%S"),
                dt.datetime.strptime(b, "%Y-%m-%d %H:%M:%S"))
               for a, b in NAB_ANOMALY_WINDOWS]
        flagged_ts = [ts[i] for i in flagged_idx]
        for a, b in win:
            if any(a <= t <= b for t in flagged_ts):
                detected += 1
        in_window = sum(test_truth[i] for i in flagged_idx)
        precision = in_window / max(len(flagged_idx), 1)
        print(f"threshold={threshold:.3f}  flagged={len(flagged_idx)}  "
              f"windows detected={detected}/{len(win)}  "
              f"precision={precision:.2f}")
        print("(reference notebook ballpark: 3/5 windows with this "
              "architecture)")
    else:
        hits = int(np.sum(test_truth[flagged_idx]))
        total = int(test_truth.sum())
        print(f"threshold={threshold:.3f}  flagged={len(flagged_idx)}  "
              f"true anomalies hit={hits}/{total}")


if __name__ == "__main__":
    main()
