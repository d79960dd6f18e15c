"""``python -m ratelimiter_tpu_torch [application.properties]`` — run the
HTTP demo service on the card."""

from ratelimiter_tpu_torch.service.app import main

if __name__ == "__main__":
    main()
