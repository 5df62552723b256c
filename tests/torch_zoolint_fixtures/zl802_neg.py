class ServingError(Exception):
    http_status = 500

    def __init__(self, message, **details):
        super().__init__(message)
        self.message = message
        self.details = details


class FixtureGone(ServingError):
    http_status = 404


class FixtureBusy(ServingError):
    http_status = 429


_ERROR_CLASSES = {
    "ServingError": ServingError,
    "FixtureGone": FixtureGone,
    "FixtureBusy": FixtureBusy,
}
