"""ZL601 negative: structured logging on the hot path, and free
print/logging OFF the hot path, are both fine."""
import logging

from analytics_zoo_tpu_torch.observability.log import get_logger

slog = get_logger("fixture.serving")
log = logging.getLogger("fixture")


def predict(x):
    slog.info("dispatch", rows=1)  # structured logger: sanctioned
    return x


def offline_report(data):
    # not reachable from any hot entry point — print/logging are fine
    print("report:", data)
    log.warning("report generated")
