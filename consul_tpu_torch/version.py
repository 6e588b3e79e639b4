"""Version info (reference: version/version.go:17); the port's copy of
``consul_tpu/version.py``, with the same version string."""

__version__ = "0.1.0"
VERSION_PRERELEASE = "dev"

# Protocol version numbers mirror the reference's agent protocol range
# (reference: vendor/memberlist/config.go ProtocolVersion2Compatible..Max).
PROTOCOL_VERSION_MIN = 1
PROTOCOL_VERSION_MAX = 3
