"""CLI entry: python -m gatekeeper_tpu_torch.service [--address A]
[--driver D] [--device DEV]"""

import argparse
import logging

from .server import serve


def main() -> None:
    p = argparse.ArgumentParser(description="gatekeeper_tpu policy service")
    p.add_argument("--address", default="127.0.0.1:50061",
                   help="bind address (host:port)")
    p.add_argument("--driver", default="torch", choices=["torch", "rego"],
                   help="evaluation backend")
    p.add_argument("--device", default="cuda",
                   help="torch device of the torch driver: cuda (the "
                        "card, the default; raises where none is "
                        "visible) or cpu")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    serve(address=args.address, driver=args.driver, device=args.device)


if __name__ == "__main__":
    main()
