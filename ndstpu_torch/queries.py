"""The rendered text of the queries the port's slices run on the card.

Each is an NDS template rendered as ``ndstpu/queries/streamgen.py``
renders it (rngseed 07291122510, stream 0): the q3 family's star-join
reports (``QUERIES``) and the store-channel reports (``STORE_QUERIES``).
``chip_smoke.py`` and :mod:`ndstpu_torch.profile` run them.
"""

QUERIES = {
    "q3": """select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manufact_id = 162
  and dt.d_moy = 11
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, sum_agg desc, brand_id
limit 100""",
    "q42": """select dt.d_year, item.i_category_id, item.i_category,
       sum(ss_ext_sales_price) total
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 12
  and dt.d_year = 2000
group by dt.d_year, item.i_category_id, item.i_category
order by total desc, dt.d_year, item.i_category_id, item.i_category
limit 100""",
    "q52": """select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11
  and dt.d_year = 1999
group by dt.d_year, item.i_brand, item.i_brand_id
order by dt.d_year, ext_price desc, brand_id
limit 100""",
    "q55": """select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 7
  and d_moy = 11
  and d_year = 1999
group by i_brand, i_brand_id
order by ext_price desc, brand_id
limit 100""",
}

# q9's five ss_quantity buckets: (low, high, count threshold)
Q9_BUCKETS = ((1, 20, 50330), (21, 40, 16645), (41, 60, 40372),
               (61, 80, 5743), (81, 100, 20142))
STORE_QUERIES = {
    "q9": "select " + ",\n       ".join(
        f"""case when (select count(*)
                  from store_sales
                  where ss_quantity between {lo} and {hi}) > {t}
            then (select avg(ss_ext_discount_amt)
                  from store_sales
                  where ss_quantity between {lo} and {hi})
            else (select avg(ss_net_paid)
                  from store_sales
                  where ss_quantity between {lo} and {hi}) end bucket{b}"""
        for b, (lo, hi, t) in enumerate(Q9_BUCKETS, 1)) + """
from reason
where r_reason_sk = 1""",
    "q43": """select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price else null end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price else null end) mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price else null end) tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price else null end) wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price else null end) thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price else null end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk
  and s_store_sk = ss_store_sk
  and s_gmt_offset = -6
  and d_year = 1999
group by s_store_name, s_store_id
order by s_store_name, s_store_id, sun_sales, mon_sales, tue_sales,
         wed_sales, thu_sales, fri_sales, sat_sales
limit 100""",
    "q88": "select *\nfrom " + ",\n     ".join(
        f"""(select count(*) {name}
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = {h} and time_dim.t_minute {op} 30
        and household_demographics.hd_dep_count = 3
        and store.s_store_name = 'ese') s{i}"""
        for i, (name, h, op) in enumerate(
            (("h8_30_to_9", 8, ">="), ("h9_to_9_30", 9, "<"),
             ("h9_30_to_10", 9, ">="), ("h10_to_10_30", 10, "<")), 1)),
    "q93": """select ss_customer_sk, sum(act_sales) sumsales
from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales
           left outer join store_returns
             on (sr_item_sk = ss_item_sk
                 and sr_ticket_number = ss_ticket_number),
           reason
      where sr_reason_sk = r_reason_sk
        and r_reason_desc = 'reason 35') t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100""",
}
